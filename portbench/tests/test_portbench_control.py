"""The precision control at a size a test run holds: the plain reference in
bfloat16, put in the program's place, fails the mark cells' check; on the
leak it decodes every payload right (PERF.md says why)."""

import pytest
import torch

import control
from conftest import LEAK, load, tiny


@pytest.mark.parametrize("name", ["flagship_1080p30.hls_variants",
                                  "dtcwtKey_1080p30.title_mark",
                                  "flagship_1080p30.title_mark"])
def test_the_bfloat16_control_fails_a_mark_cell(name):
    cell = tiny(load(name))
    cell.traffic["check_frames"] = 8
    out = control.control(cell, 2**31 + 1, "cpu")
    assert "diff_ppm" in out["failed"], out


def test_the_bfloat16_control_on_the_leak_reads_no_payload_error():
    out = control.control(tiny(load(LEAK)), 2**31 + 1, "cpu")
    assert out["numbers"]["payload_errors"] == 0 and out["failed"] == [], out


def test_the_reference_is_float32_without_tf32():
    from reference import strict_fp32

    strict_fp32()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
