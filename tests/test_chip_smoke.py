"""chip_smoke.py's pieces on the CPU: it refuses to run without a GPU or
without the repository, its last-line format, and the checks it applies
(tie adjudication, map agreement, volume errors)."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

from stereo_matchin_tpu.eval import adjudicate_ties, argmin_tie_gap  # noqa: E402


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("args", [[], ["--four"]], ids=["one", "four"])
def test_exits_nonzero_without_gpu(args):
    r = _run([str(REPO / "chip_smoke.py"), *args], REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_exits_nonzero_without_the_repository(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = _run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_ok_line_is_the_contract_line():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    line = chip_smoke.ok_line([Dev()])
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def test_tie_adjudication_accepts_proven_ties():
    costs = np.full((4, 1, 1000), 5.0, np.float32)
    costs[1, 0, 0] = 1.0
    costs[2, 0, 0] = np.nextafter(np.float32(1.0), np.float32(2.0))
    got = np.zeros((1, 1, 1000))
    want = got.copy()
    want[0, 0, 0] = 2.0                 # plane 2 won instead, 1 ulp away
    assert adjudicate_ties(got, want, lambda b: costs) == 1
    assert adjudicate_ties(got, got, lambda b: costs) == 0


def test_tie_adjudication_rejects_real_disagreement():
    costs = np.zeros((3, 1, 1000), np.float32) + 9.0
    costs[0, 0, 0], costs[1, 0, 0] = 1.0, 1.5      # 50% gap: no tie
    got, want = np.zeros((1, 1, 1000)), np.zeros((1, 1, 1000))
    want[0, 0, 0] = 1.0
    with pytest.raises(AssertionError):
        adjudicate_ties(got, want, lambda b: costs)


def test_tie_adjudication_rejects_too_many_flips():
    costs = np.ones((2, 1, 10), np.float32)        # every pixel a tie
    got, want = np.zeros((1, 1, 10)), np.ones((1, 1, 10))
    with pytest.raises(AssertionError):
        adjudicate_ties(got, want, lambda b: costs)


def test_argmin_tie_gap():
    c = np.array([[3.0], [1.0], [1.5]])
    np.testing.assert_allclose(argmin_tie_gap(c), [0.5])


def test_map_and_volume_checks():
    a = np.arange(12.0).reshape(3, 4)
    b = a.copy()
    b[0, 0] = 99
    assert chip_smoke.agreement(a, a) == 1.0
    assert chip_smoke.agreement(a, b) == 11 / 12
    want = np.array([1e-6, 2.0, 4.0])
    got = want * np.array([1.5, 1.0, 1.0])
    # Near-zero entries blow up the elementwise error, not the normwise.
    assert chip_smoke.max_rel_err(got, want) == pytest.approx(0.5)
    assert chip_smoke.normwise_err(got, want) == pytest.approx(5e-7 / 4)
    with pytest.raises(AssertionError, match="non-finite"):
        chip_smoke.max_rel_err(np.array([np.nan]), np.array([1.0]))
    with pytest.raises(AssertionError, match="out of limits"):
        chip_smoke.check("x", False, 3)


def test_mismatches_lists_unequal_pixels():
    got = np.zeros((2, 3, 4))
    got[1, 2, 3] = 1.0
    assert chip_smoke.mismatches(got, [np.zeros((3, 4))] * 2) == [
        (1, 2, 3, 1.0, 0.0)]
