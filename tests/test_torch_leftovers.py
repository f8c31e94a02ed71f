"""The port's last small modules against vfp_tpu, on the CPU: ``ops/svd4.py``
and ``ops/blocks.py``, ``utils/profiling.py`` (``cli mark --profile``,
``StageTimer``), ``utils/logging.py:trace``, ``DtcwtKey.mark_frames_hp`` and
``DeCorrShuffler``'s slow mode.

Stated tolerances: the dominant singular value within 1e-5 relative of the
JAX function and ``B v0 = s0 u0`` to 1e-5 (of max(s0, 1)); blocks,
``StageTimer`` reports, trace lines and ``mark_frames_hp`` exactly equal;
the slow-mode correlation within 1e-6 of the JAX package's, the decision
equal.
"""

import logging
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import correlate2d

from vfp_tpu.ops import blocks as jblocks, svd4 as jsvd4
from vfp_tpu.utils import logging as jlogging, profiling as jprofiling
from vfp_tpu.wm import payload_img as jpimg
from vfp_tpu_torch.cli import main as port_cli
from vfp_tpu_torch.io import RawVideoWriter
from vfp_tpu_torch.ops import from_blocks, to_blocks, top_singular_triplet, top_singular_value
from vfp_tpu_torch.utils import StageTimer, profile_trace, trace
from vfp_tpu_torch.wm import CorrShuffler, DeCorrShuffler, DtcwtKey

from torch_parity import natural_frames

torch.set_num_threads(1)


# -- svd4 -----------------------------------------------------------------------------

def _batches(rng):
    rand = rng.randn(64, 4, 4).astype(np.float32) * 40
    zero = np.zeros((3, 4, 4), np.float32)
    rank1 = np.einsum("bi,bj->bij", rng.randn(8, 4), rng.randn(8, 4)).astype(np.float32) * 9
    q, _ = np.linalg.qr(rng.randn(8, 4, 4))
    s = np.array([5.0, 5.0 * (1 - 1e-6), 2.0, 0.5])
    tied = np.einsum("bij,j,bkj->bik", q, s, q).astype(np.float32)  # symmetric, near-tied top
    return {"random": rand, "zero": zero, "rank1": rank1, "near_tied": tied}


@pytest.mark.parametrize("method", ["jacobi", "power"])
@pytest.mark.parametrize("kind", ["random", "zero", "rank1", "near_tied"])
def test_svd4_matches_jax(method, kind):
    b = _batches(np.random.RandomState(4))[kind]
    s0, u, v = top_singular_triplet(torch.as_tensor(b), method)
    js0, ju, jv = (np.asarray(x) for x in jsvd4.top_singular_triplet(jnp.asarray(b), method))
    assert s0.dtype == u.dtype == v.dtype == torch.float32
    s0, u, v = s0.numpy(), u.numpy(), v.numpy()
    np.testing.assert_allclose(s0, js0, rtol=1e-5, atol=0)
    scale = np.maximum(s0, 1.0)[:, None]
    np.testing.assert_allclose(np.einsum("bij,bj->bi", b, v) / scale, s0[:, None] * u / scale,
                               atol=1e-5, rtol=0)
    sv = top_singular_value(torch.as_tensor(b), method).numpy()
    np.testing.assert_allclose(sv, np.asarray(jsvd4.top_singular_value(jnp.asarray(b), method)),
                               rtol=1e-5, atol=0)
    if kind == "zero":  # the unit-vector fallbacks, as the JAX function
        assert np.all(s0 == 0)
        np.testing.assert_array_equal(u, ju)
        np.testing.assert_array_equal(v, jv)
    if kind == "random":  # and the dominant singular value itself
        want = np.linalg.svd(b.astype(np.float64), compute_uv=False)[:, 0]
        np.testing.assert_allclose(s0, want, rtol=1e-5)


def test_svd4_iters_and_method_errors():
    b = torch.as_tensor(_batches(np.random.RandomState(5))["random"])
    for method, iters in (("jacobi", 2), ("power", 3)):
        got = top_singular_value(b, method, iters).numpy()
        want = np.asarray(jsvd4.top_singular_value(jnp.asarray(b.numpy()), method, iters))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    with pytest.raises(ValueError, match="unknown svd method"):
        top_singular_triplet(b, "qr")


# -- blocks ---------------------------------------------------------------------------

@pytest.mark.parametrize("blk", [4, 8])
def test_blocks_round_trip_and_equal_jax(blk):
    img = np.random.RandomState(6).rand(2, 3, 16, 24).astype(np.float32)
    got = to_blocks(torch.as_tensor(img), blk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jblocks.to_blocks(jnp.asarray(img), blk)))
    assert got.shape == (2, 3, (16 // blk) * (24 // blk), blk, blk)
    assert torch.equal(from_blocks(got, 16, 24), torch.as_tensor(img))


# -- profiling and trace --------------------------------------------------------------

def test_stage_timer_reports_as_the_jax_one(monkeypatch):
    def run(timer_cls):
        ticks = iter([0.0, 0.123456, 1.0, 1.5, 2.0, 2.0])
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        t = timer_cls()
        with t.stage("decode", items=16):
            pass
        with t.stage("mark", items=7):
            pass
        with t.stage("idle"):
            pass
        return t.report()

    got, want = run(StageTimer), run(jprofiling.StageTimer)
    assert got == want
    assert got["decode"] == {"seconds": 0.1235, "items": 16, "items_per_sec": 129.6}
    assert got["idle"]["items_per_sec"] == 0.0


def test_trace_logs_each_call_as_the_jax_one(caplog):
    lines = {}
    for name, deco in (("port", trace), ("jax", jlogging.trace)):
        log = logging.getLogger(f"vfp_test_trace_{name}")

        @deco(log)
        def mark_batch(x, scale=2):
            """Doubles."""
            return x * scale

        caplog.clear()
        with caplog.at_level(logging.DEBUG, logger=log.name):
            assert mark_batch(3, scale=4) == 12
        lines[name] = [(r.levelno, r.getMessage()) for r in caplog.records]
        assert mark_batch.__name__ == "mark_batch" and mark_batch.__doc__ == "Doubles."
    assert lines["port"] == lines["jax"] == [(logging.DEBUG, "Entering mark_batch()")]


def test_verbose_help_names_the_trace_decorators(capsys):
    with pytest.raises(SystemExit):
        port_cli(["--help"])
    assert "(incl. @trace decorators)" in " ".join(capsys.readouterr().out.split())


def test_mark_profile_writes_a_chrome_trace(tmp_path, capsys):
    src = tmp_path / "in.rawv"
    with RawVideoWriter(src, 96, 64, fps=6) as w:
        w.write_batch(natural_frames(np.random.RandomState(7), 6, 64, 96))
    prof = tmp_path / "prof"
    port_cli(["mark", str(src), str(tmp_path / "out.rawv"), "--profile", str(prof),
              "--batch-size", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"profiler trace -> {prof}" in out and "marked 6 frames" in out
    traces = list(prof.glob("trace_*.json"))
    assert len(traces) == 1
    import json

    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("mark" in str(e.get("name", "")) or e.get("cat") == "cpu_op" for e in events)


def test_profile_trace_traces_the_cpu_alone_without_cuda(tmp_path):
    with profile_trace(tmp_path / "p", device="cpu") as prof:
        torch.ones(8).sum()
    assert torch.profiler.ProfilerActivity.CUDA not in prof.activities
    assert len(list((tmp_path / "p").glob("trace_*.json"))) == 1


# -- DtcwtKey.mark_frames_hp and the slow presence mode -------------------------------

@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_mark_frames_hp_equals_mark_frames(dtype):
    codec = DtcwtKey()
    frames = torch.as_tensor(natural_frames(np.random.RandomState(8), 3, 64, 112).astype(dtype))
    wm = torch.as_tensor(CorrShuffler(key=3).generate_wm(None, codec.wm_capacity((64, 112, 3))))
    hp = codec.wm_hp_device((64, 112), wm)
    ri = torch.stack([hp.real, hp.imag])
    assert ri.shape == (2, *hp.shape) and ri.dtype == torch.float32
    assert torch.equal(codec.mark_frames_hp(frames, ri), codec.mark_frames(frames, wm))


def test_degenerate_slow_mode_matches_jax():
    codec = DtcwtKey()
    frames = natural_frames(np.random.RandomState(9), 2, 64, 112)
    cap = codec.wm_capacity((64, 112, 3))
    wm = CorrShuffler(key=3).generate_wm(None, cap)
    marked = codec.mark_frames(torch.as_tensor(frames), torch.as_tensor(wm))
    planes = codec.extract_frames(marked).numpy()
    for key in (3, 5):
        deg, jdeg = DeCorrShuffler(key=key), jpimg.DeCorrShuffler(key=key)
        for plane in planes:
            got = deg.correlation(plane, mode="slow")
            want = float((correlate2d(plane, jdeg._reference(plane.shape))
                          / plane.size).max())
            assert abs(got - want) <= 1e-6, (got, want)
            decision = deg.degenerate(plane, mode="slow")
            assert decision == jdeg.degenerate(plane, mode="slow")
            assert deg.degenerate(torch.as_tensor(plane), mode="slow") == decision
            assert deg.degenerate(plane) == jdeg.degenerate(plane)
