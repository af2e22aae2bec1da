"""The ``retrieval`` kind: top-kappa maximum-inner-product retrieval over a
catalog of latent factors, served by ``repro_torch``'s retriever API
(``gpubench/system.py``).  A configuration that names no ``system`` is of
this kind.

A query is one user: a request of ``request_size`` users answers that
many.  A configuration holds ``data`` (the catalog, read by
``gen/traffic.py``), ``gam`` (the map's ``GamConfig`` fields) and ``spec``
(``RetrieverSpec`` fields; ``bucket`` is set here, from the reference's
own phi).  The comparison is ``reference/compare.py``'s; the control is
``reference/control.py``'s.

Readers of this kind read two attributes it sets on the run: ``n_scored``
(each request's candidates, ``None`` where it failed) and ``n_live`` (the
catalog rows served in the window).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from gpubench.gen import traffic as gen
from gpubench.reference.compare import NUMBERS, judge as _judge
from gpubench.reference.control import Control
from gpubench.reference.phi import parse_tree_dim, posting_lengths
from gpubench.reference.retrieval import Answer, Catalog, answer, live_catalog
from gpubench.system import System

__all__ = ["KEPT", "NUMBERS", "Reference", "control", "draw", "judge",
           "live", "open_system", "prepare", "recorder", "sample"]

#: rows of each answer the window keeps for the comparison to draw from
KEPT = 32


@dataclasses.dataclass
class Reference:
    """Set-up's work of the benchmark, not of the program."""

    base: Catalog             # the catalog as drawn, with its phi maps
    bucket: int               # the longest posting list: no list spills


def draw(config: dict, traffic: dict, seed: int) -> gen.Traffic:
    """The catalog, the users, their walk and set-up's mutations."""
    return gen.make(config["data"], traffic, seed)


def prepare(config: dict, data: gen.Traffic, device) -> Reference:
    base = Catalog.of(data.ids, data.items, float(config["gam"]["threshold"]),
                      device=device)
    bucket = int(posting_lengths(base.tau, base.mask,
                                 parse_tree_dim(base.tau.shape[1])).max())
    return Reference(base, bucket)


def open_system(root, config: dict, data: gen.Traffic, ref: Reference, *,
                device: str, traced: bool) -> System:
    return System(root, config, data.ids, data.items, bucket=ref.bucket,
                  device=device, traced=traced)


def _kept_rows(keep_seed: int, i: int, b: int, m: int) -> np.ndarray:
    """The rows of request ``i`` whose answers the window keeps for the
    comparison: ``m`` of its ``b``, drawn from the run's seed."""
    rng = np.random.default_rng([keep_seed, i])
    return np.sort(rng.choice(b, min(m, b), replace=False))


def recorder(run, seed: int):
    """-> ``record(i, users, res)``: a request's queries and what the
    window keeps of it, ``(i, rows, (ids, scores, n_scored) of the rows)``;
    each request's candidates go to ``run.n_scored``."""
    keep_seed = gen.seeds(seed, 5)[4]
    run.n_scored = []

    def record(i: int, users, res) -> tuple[int, tuple]:
        rows = _kept_rows(keep_seed, i, len(users), KEPT)
        run.n_scored.append(None if res is None
                            else int(np.sum(res.n_scored)))
        return len(users), (i, rows, None if res is None else (
            np.asarray(res.ids)[rows], np.asarray(res.scores)[rows],
            np.asarray(res.n_scored)[rows]))

    return record


def sample(run, seed: int) -> tuple[np.ndarray, Answer]:
    """The kept answers, ``traffic["sample"]`` of them drawn from the seed
    -> (users, the served answer)."""
    kappa = int(run.config["spec"]["kappa"])
    users, ids, scores, n = [], [], [], []
    for i, rows, got in run.kept:
        users.append(run.data.request(i)[rows])
        if got is None:               # a failed request serves nothing
            ids.append(np.full((rows.size, kappa), -1, np.int64))
            scores.append(np.full((rows.size, kappa), -np.inf, np.float32))
            n.append(np.full(rows.size, -1, np.int64))
        else:
            ids.append(got[0])
            scores.append(got[1])
            n.append(got[2])
    users, ids = np.concatenate(users), np.concatenate(ids)
    rng = np.random.default_rng(gen.seeds(seed, 6)[5])
    pick = np.sort(rng.choice(len(users), min(run.data.sample, len(users)),
                              replace=False))
    return users[pick], Answer(ids[pick], np.concatenate(scores)[pick],
                               np.concatenate(n)[pick])


def live(data: gen.Traffic, threshold: float, base: Catalog | None = None,
         precision: str = "f32", device="cpu") -> Catalog:
    """The live catalog after set-up's mutations, with its phi maps."""
    if not data.mutations and base is not None:
        return base
    ids, fac = (live_catalog(data.ids, data.items, data.mutations)
                if data.mutations else (data.ids, data.items))
    return Catalog.of(ids, fac, threshold, precision, device)


def judge(run, ref: Reference, seed: int) -> dict:
    """The comparison's numbers for the answers ``run`` served."""
    cfg, thr = run.config, float(run.config["gam"]["threshold"])
    cat = live(run.data, thr, ref.base, device=run.device)
    run.n_live = len(cat.ids)
    users, served = sample(run, seed)
    mo = int(cfg["spec"]["min_overlap"])
    exact = answer(cat, users, threshold=thr, min_overlap=mo,
                   kappa=int(cfg["spec"]["kappa"]), device=run.device)
    return _judge(served, exact, cat, users, threshold=thr, min_overlap=mo,
                  device=run.device)


def control(run, ref: Reference) -> tuple[Control, int]:
    """The reference one precision step down, in the program's place, and
    the requests it has to answer to fill the sample."""
    thr = float(run.config["gam"]["threshold"])
    ctl = Control(live(run.data, thr, precision="low", device=run.device),
                  run.config, run.device)
    return ctl, -(-run.data.sample // min(KEPT, run.data.request_size))
