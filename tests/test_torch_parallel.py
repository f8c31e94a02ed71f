"""vfp_tpu_torch.parallel's mesh and sharded steps against vfp_tpu.parallel, on
the CPU.

The JAX steps run in this process on the 8-device virtual CPU mesh
(tests/conftest.py), as tests/test_parallel.py runs them.  The port's run
as 4 gloo ranks (``torch_rank_worker.py``, one CPU thread each, killed
after 120 s), all jobs in one launch per module; inputs are made here from
a seed with numpy and handed over as .npy files.  Stated tolerances: the
flagship codec bit for bit (JAX step, JAX ``mark_frames`` and the port's
single-device ``mark_frames``); ``DtcwtKey`` and ``DctQim`` equal to the
port's own single-device marks, and within the JAX file's own bound of the
JAX step (|diff| <= 1 on < 1e-3 of pixels; ``DctQim``'s decoded bits equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfp_tpu.fingerprint import payload_for_segment
from vfp_tpu.parallel import make_mesh as jax_make_mesh
from vfp_tpu.parallel import sharded as jsh
from vfp_tpu.wm import DctQim as JaxDctQim, DeShuffler as JaxDeShuffler, DwtDctSvd as JaxCodec
from vfp_tpu.wm import Shuffler as JaxShuffler
from vfp_tpu.wm.dtcwt_codecs import DtcwtKey as JaxDtcwtKey
from vfp_tpu_torch.parallel import make_mesh
from vfp_tpu_torch.parallel.mesh import free_port
from vfp_tpu_torch.wm import DctQim, DtcwtKey, DwtDctSvd

from torch_parity import natural_frames
from torch_rank_worker import run_ranks

torch.set_num_threads(1)
WORLD = 4


def _flagship_wms(h, w, seg, copies):
    cap = JaxCodec().wm_capacity((h, w, 3))
    return np.stack([JaxShuffler(key=0).generate_wm(payload_for_segment(seg, c), cap).flatten()
                     for c in range(copies)]).astype(np.float32)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Every job's inputs, made from one seed."""
    d = tmp_path_factory.mktemp("ranks")
    rng = np.random.RandomState(15)
    x = {"dir": d}
    x["flag_frames"] = natural_frames(rng, 8, 32, 48)
    x["flag_wms"] = _flagship_wms(32, 48, 1, 2)
    x["dt_frames"] = natural_frames(rng, 8, 64, 112)
    cap = DtcwtKey().wm_capacity((64, 112, 3))
    x["dt_wms"] = rng.randint(0, 2, (2, cap[0] * cap[1])).astype(np.float32)
    cap = DctQim().wm_capacity((64, 112, 3))
    x["dct_wms"] = rng.randint(0, 2, (2, cap[0] * cap[1])).astype(np.float32)
    # detect: frames the port marks with segment 2 copy 1's payload
    for name, b, w in (("det22", 8, 48), ("det41", 16, 32)):
        frames = natural_frames(rng, b, 32, w)
        wm = _flagship_wms(32, w, 2, 2)[1]
        x[name] = DwtDctSvd().mark_frames(torch.as_tensor(frames), torch.as_tensor(wm)).numpy()
    x["cands"] = np.stack([payload_for_segment(2, c) for c in range(3)]).astype(np.float32)
    x["sp_frames"] = natural_frames(rng, 2, 64, 256)
    wm = _flagship_wms(64, 256, 2, 2)[1]
    nbh, nbw = (64 // 2) // 4, (256 // 2) // 4
    x["sp_wm"] = wm
    x["sp_wm2d"] = wm.reshape(-1)[: nbh * nbw].reshape(nbh, nbw)
    for k, v in list(x.items()):
        if isinstance(v, np.ndarray):
            np.save(d / f"{k}.npy", v)
    return x


@pytest.fixture(scope="module")
def ranks(inputs):
    """One 4-rank gloo launch for every job of this module."""
    d = inputs["dir"]
    f = {k: str(d / f"{k}.npy") for k in inputs if k != "dir"}
    jobs = [
        {"name": "mesh", "kind": "mesh"},
        {"name": "flag", "kind": "mark", "codec": "dwtDctSvd", "mesh": [2, 2],
         "frames": f["flag_frames"], "wms": f["flag_wms"]},
        {"name": "dtcwt", "kind": "mark", "codec": "dtcwtKey", "mesh": [2, 2],
         "frames": f["dt_frames"], "wms": f["dt_wms"]},
        {"name": "dct", "kind": "mark", "codec": "dct", "mesh": [2, 2],
         "frames": f["dt_frames"], "wms": f["dct_wms"]},
        {"name": "det22", "kind": "detect", "mesh": [2, 2], "frames": f["det22"],
         "cands": f["cands"]},
        {"name": "det41", "kind": "detect", "mesh": [4, 1], "frames": f["det41"],
         "cands": f["cands"]},
        {"name": "spatial", "kind": "spatial", "mesh": [4, 1], "frames": f["sp_frames"],
         "wm2d": f["sp_wm2d"]},
    ]
    results = run_ranks(WORLD, jobs, d / "out", port=free_port())
    return results, d / "out"


@pytest.fixture(scope="module")
def mesh42():
    return jax_make_mesh(data=4, variant=2)


def test_make_mesh_raises_on_a_size_mismatch_before_making_a_group():
    import torch.distributed as dist

    for data, variant in ((2, 1), (1, 2), (None, 2)):
        with pytest.raises(ValueError, match=r"!= 1 devices"):
            make_mesh(data, variant, device="cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        make_mesh(device="meta")
    assert not dist.is_initialized()


def test_mesh_coordinates_are_jax_meshs(ranks):
    results, _ = ranks
    jmesh = jax_make_mesh(data=2, variant=2, devices=jax.devices()[:WORLD])
    ids = [d.id for d in jax.devices()[:WORLD]]
    for (a, b), dev in np.ndenumerate(jmesh.devices):
        assert results[ids.index(dev.id)]["mesh"]["coordinate"] == [a, b]
    for r in results:
        assert r["mesh"]["default_data"] == 2
        assert r["mesh"]["size_error"] == "mesh 3x1 != 4 devices"
        assert "nccl" in r["mesh"]["backend_error"]


def test_sharded_mark_flagship_equals_jax_step_and_single_device(ranks, inputs, mesh42):
    results, out = ranks
    got = np.load(out / "flag.npy")
    frames, wms = inputs["flag_frames"], inputs["flag_wms"]
    assert got.shape == (2, 8, 32, 48, 3) and got.dtype == np.uint8
    assert all(r["flag"]["block"] == [1, 4, 32, 48, 3] for r in results)
    want = np.asarray(jsh.sharded_mark_step(mesh42, JaxCodec())(jnp.asarray(frames),
                                                                jnp.asarray(wms)))
    np.testing.assert_array_equal(got, want)
    for v in range(2):
        np.testing.assert_array_equal(got[v], np.asarray(JaxCodec().mark_frames(
            jnp.asarray(frames), jnp.asarray(wms[v]))))
        single = DwtDctSvd().mark_frames(torch.as_tensor(frames), torch.as_tensor(wms[v]))
        assert torch.equal(torch.as_tensor(got[v]), single)


@pytest.mark.parametrize("name", ["dtcwt", "dct"])
def test_sharded_mark_dtcwt_and_dct_qim(ranks, inputs, mesh42, name):
    _, out = ranks
    got = np.load(out / f"{name}.npy")
    frames = inputs["dt_frames"]
    wms = inputs[{"dtcwt": "dt_wms", "dct": "dct_wms"}[name]]
    port, jax_codec = ((DtcwtKey(), JaxDtcwtKey(fast_dots=False)) if name == "dtcwt"
                       else (DctQim(), JaxDctQim()))
    want = np.asarray(jsh.sharded_mark_step(mesh42, jax_codec)(jnp.asarray(frames),
                                                               jnp.asarray(wms)))
    assert got.shape == want.shape == (2, 8, 64, 112, 3)
    for v in range(2):
        single = port.mark_frames(torch.as_tensor(frames), torch.as_tensor(wms[v]))
        assert torch.equal(torch.as_tensor(got[v]), single)
        diff = got[v].astype(np.int32) - want[v].astype(np.int32)
        assert np.abs(diff).max() <= 1
        assert (diff != 0).mean() < 1e-3, (diff != 0).mean()
        if name == "dct":
            bits = port.extract_frames(torch.as_tensor(got[v])).numpy()
            np.testing.assert_array_equal(
                bits, np.asarray(jax_codec.extract_frames(jnp.asarray(want[v]))))


@pytest.mark.parametrize("name,mesh,n", [("det22", (2, 2), 8), ("det41", (4, 1), 16)])
def test_sharded_detect_votes_equal_jax(ranks, inputs, name, mesh, n):
    results, _ = ranks
    for r in results:  # the all_reduce over 'data' leaves the votes on every rank
        assert r[name]["votes"] == [0, n, 0] and r[name]["dtype"] == "torch.int32"
    jmesh = jax_make_mesh(*mesh, devices=jax.devices()[:WORLD])
    jdeg = JaxDeShuffler(key=0, threshold="fixed").set_shape((8,))
    votes = np.asarray(jsh.sharded_detect_step(jmesh, JaxCodec(), jdeg, 3)(
        jsh.shard_batch(jmesh, jnp.asarray(inputs[name])), jnp.asarray(inputs["cands"])))
    assert votes.tolist() == results[0][name]["votes"]


def test_sharded_mark_spatial_equals_the_unsharded_jax_mark(ranks, inputs):
    results, out = ranks
    got = np.load(out / "spatial.npy")
    want = np.asarray(JaxCodec().mark_frames(jnp.asarray(inputs["sp_frames"]),
                                             jnp.asarray(inputs["sp_wm"])))
    np.testing.assert_array_equal(got, want)
    for r in results:
        assert r["spatial"]["local"] == [2, 64, 64, 3]
        assert r["spatial"]["misaligned_error"] == \
            "W=100 must be a multiple of 32 for spatial sharding"


def test_shard_helpers_raise_when_an_axis_does_not_divide(monkeypatch):
    """shard_batch / shard_variants on a mesh stand-in: the checks and the
    slices need no process group."""
    from vfp_tpu_torch.parallel import sharded as sh

    class Mesh:
        mesh_dim_names = ("data", "variant")
        device_type = "cpu"

        def size(self, dim):
            return (2, 3)[dim]

        def get_local_rank(self, name):
            return {"data": 1, "variant": 2}[name]

    x = np.arange(4 * 5).reshape(4, 5).astype(np.uint8)
    assert torch.equal(sh.shard_batch(Mesh(), x), torch.as_tensor(x[2:]))
    wms = np.arange(6 * 2).reshape(6, 2)
    part = sh.shard_variants(Mesh(), wms)
    assert part.dtype == torch.float32
    assert torch.equal(part, torch.as_tensor(wms[4:], dtype=torch.float32))
    col = sh.shard_axis(Mesh(), np.arange(24).reshape(2, 12), 1)
    assert col.is_contiguous() and torch.equal(col, torch.arange(24).reshape(2, 12)[:, 6:])
    with pytest.raises(ValueError, match="does not split over 2 'data' ranks"):
        sh.shard_batch(Mesh(), x[:3])
    with pytest.raises(ValueError, match="does not split over 3 'variant' ranks"):
        sh.shard_variants(Mesh(), wms[:4])
