"""``chip_smoke.py`` off the card: it must refuse to run without a CUDA
device, and refuse to run outside the repository; its ``drive_gemm`` and
``drive_qr`` are rehearsed here at a tiny size on the port's CPU-backed device
module."""

import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _run(cwd, script):
    return subprocess.run([sys.executable, str(script)], cwd=str(cwd),
                          capture_output=True, text=True, timeout=120)


def test_refuses_without_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible here")
    res = _run(ROOT, ROOT / "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_refuses_outside_the_repository(tmp_path):
    script = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", script)
    res = _run(tmp_path, script)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


NO_LAUNCHES = {"gemm_tile": 0, "gram_tile": 0}


@pytest.mark.parametrize("mb,t", [(24, 2), (8, 4)])
def test_gemm_driver_rehearsal_on_cpu(mb, t):
    chip_smoke = _chip_smoke()
    from parsec_tpu_torch.core.context import Context
    with Context(nb_cores=2, device="cpu") as ctx:
        res = chip_smoke.drive_gemm(ctx, mb, t, t, t + 1, passes=1,
                                    gen=torch.Generator().manual_seed(3),
                                    label="rehearsal")
    assert res["ntasks"] == t * t * (t + 1)
    # CPU tensors: the plain versions ran
    assert res["launches"] == NO_LAUNCHES


@pytest.mark.parametrize("dtype,mb,nt,ib", [
    (torch.bfloat16, 32, 3, 16), (torch.float32, 16, 4, 0)],
    ids=["bf16-blocked", "f32-unblocked"])
def test_qr_driver_rehearsal_on_cpu(dtype, mb, nt, ib):
    """The QR path's driver end to end at a tiny size: regenerated tiles,
    per-class incarnation counts, zero lower tiles, the residual and the
    least-squares ladder within the limits the card run holds."""
    chip_smoke = _chip_smoke()
    from parsec_tpu_torch.core.context import Context
    from parsec_tpu_torch.utils.mca import params
    params.set("qr_ib", ib)
    try:
        with Context(nb_cores=2, device="cpu") as ctx:
            res = chip_smoke.drive_qr(ctx, mb, nt, dtype, passes=1,
                                      label="rehearsal")
    finally:
        params.unset("qr_ib")
    assert res["ntasks"] == sum(chip_smoke.qr_task_counts(nt).values())
    assert res["launches"] == NO_LAUNCHES
    assert res["fallbacks"] == 0
    assert res["residual"] <= chip_smoke.QR_RESIDUAL_TOL
    assert min(res["ladder"]) <= chip_smoke.QR_LADDER_TOL


def test_bench_operand_defeats_the_ladder_and_the_conditioned_one_not():
    """The ladder contracts only while cond^2 * eps_bf16 < 1: the geqrf
    bench operand's structure (0.05 * N(0, 1) + I in every tile) breaks
    that bound by orders of magnitude already at n = 384, nt = 8, and the
    conditioned operand keeps it (qr_operand_cond.py prints the values at
    larger n)."""
    sys.path.insert(0, str(ROOT))
    try:
        import qr_operand_cond
    finally:
        sys.path.remove(str(ROOT))
    eps = qr_operand_cond.EPS_BF16
    assert qr_operand_cond.operand_cond(48, 8, False) ** 2 * eps > 1e3
    assert qr_operand_cond.operand_cond(48, 8, True) ** 2 * eps < 0.1


def test_qr_task_counts_at_the_bench_geometry():
    assert _chip_smoke().qr_task_counts(8) == {
        "GEQRT": 8, "UNMQR": 28, "TSQRT": 28, "TSMQR": 140}
