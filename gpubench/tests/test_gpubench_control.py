"""The comparison finds the control (the reference one precision step
down, in the program's place) not correct, and the program correct, at a
size a test run holds.  On the card, ``gpubench/control.py`` reads both at
each cell's own size."""
import json

import pytest
import torch

from gpubench.tests._common import RETRIEVAL_CELLS, small
from gpubench import bench


def _readings(cell, seed, device="cpu"):
    run, system, prepared, limits = bench.set_up(
        cell, seed, device=device, overrides=small(cell))
    bench._window(run, system, 0.0, False, seed, min_requests=8)
    system.close()
    program = bench.judge_run(run, prepared, seed)
    ctl, _ = run.system_kind.control(run, prepared)
    crun = bench.Run(run.name, run.config, run.traffic, run.data,
                     run.system_kind, run.device)
    bench._window(crun, ctl, 0.0, False, seed, min_requests=8)
    return program, bench.judge_run(crun, prepared, seed), limits


@pytest.mark.parametrize("cell", RETRIEVAL_CELLS)
@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_control_is_not_correct(cell, seed):
    program, control, limits = _readings(cell, seed)
    assert all(program[n] <= limits[n] for n in limits), program
    assert any(control[n] > limits[n] for n in limits), control
    # the control's scores are TF32's, far past the limit
    assert control["score_err"] > 10 * limits["score_err"]


@pytest.mark.cuda
def test_control_is_not_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell in RETRIEVAL_CELLS:
        program, control, limits = _readings(cell, 7, device="cuda")
        assert all(program[n] <= limits[n] for n in limits), (cell, program)
        assert any(control[n] > limits[n] for n in limits), (cell, control)
        print(json.dumps({"cell": cell, "program": program,
                          "control": control}))
