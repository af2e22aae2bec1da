"""A run with the timed path broken underneath comes out not correct: for
each fault a cell can have, planted in the program on the CPU, the rest of
the run as it is (one card: no exchange between chips to leave out)."""
import numpy as np
import pytest

from gpubench.tests._common import RETRIEVAL_CELLS, small
from gpubench import bench


def _run(cell):
    return bench.run(cell, 11, 0.3, False, device="cpu",
                     overrides=small(cell))


def _alter_ids(monkeypatch, module):
    """Every answer's best row moved to its neighbour where produced."""
    real = module.gam_retrieve

    def altered(*args, **kw):
        res = real(*args, **kw)
        rows = res.rows.clone()
        rows[:, 0] = (rows[:, 0] + 1) % args[4].n_rows
        return res._replace(rows=rows)

    monkeypatch.setattr(module, "gam_retrieve", altered)


@pytest.mark.parametrize("cell", RETRIEVAL_CELLS)
def test_an_answer_altered_where_produced(cell, monkeypatch):
    import repro_torch.retriever.gam as gam
    import repro_torch.service.sharded_index as sharded_index
    _alter_ids(monkeypatch, sharded_index if "sharded" in cell else gam)
    out = _run(cell)
    assert not out["correct"]
    assert out["checks"]["rank_gap"]["value"] > \
        out["checks"]["rank_gap"]["limit"]


@pytest.mark.parametrize("cell", RETRIEVAL_CELLS)
def test_half_the_batch_left_out(cell, monkeypatch):
    """The first half of each request answered, its answers served for the
    second half as well."""
    from gpubench.system import System
    real = System.query

    def half(self, users):
        h = len(users) // 2
        res = real(self, users[:h])
        for f in ("ids", "scores", "n_scored", "discarded_frac"):
            a = np.asarray(getattr(res, f))
            setattr(res, f, np.concatenate([a, a[:len(users) - h]]))
        return res

    monkeypatch.setattr(System, "query", half)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", RETRIEVAL_CELLS)
def test_a_step_that_leaves_its_state_unchanged(cell, monkeypatch):
    """gam-device: every request answered with the first one's answer;
    sharded: set-up's upserts and deletes never land."""
    from gpubench.system import System
    if "sharded" in cell:
        monkeypatch.setattr(System, "mutate", lambda self, op: None)
    else:
        real, seen = System.query, []

        def stale(self, users):
            if not seen:
                seen.append(real(self, users))
            return seen[0]

        monkeypatch.setattr(System, "query", stale)
    assert not _run(cell)["correct"]


def test_a_request_that_fails_is_counted(monkeypatch):
    from gpubench.system import System
    real, calls = System.query, []

    def flaky(self, users):
        calls.append(1)
        if len(calls) == 2:            # the window's first request
            raise RuntimeError("planted")
        return real(self, users)

    monkeypatch.setattr(System, "query", flaky)
    out = _run(RETRIEVAL_CELLS[0])
    assert out["failed"] == 1 and not out["correct"]


def test_the_sound_program_is_correct():
    for cell in RETRIEVAL_CELLS:
        out = _run(cell)
        assert out["correct"], (cell, out["checks"])
