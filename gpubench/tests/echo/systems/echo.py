"""A kind of system for the harness's tests alone: it serves a plain torch
stand-in (each row of a request scaled by the factor set-up's one mutation
sets) and no part of the program.  A query is one row."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

NUMBERS = ("max_err",)
SCALE = 2.0


@dataclasses.dataclass
class Rows:
    rows: np.ndarray          # (n, k) f32, drawn from the seed
    request_size: int
    warmup_requests: int
    mutations: list

    def request(self, i: int) -> np.ndarray:
        at = (i * self.request_size + np.arange(self.request_size)) \
            % len(self.rows)
        return self.rows[at]


def draw(config: dict, traffic: dict, seed: int) -> Rows:
    shape = (int(config["data"]["n"]), int(config["data"]["k"]))
    rows = np.random.default_rng(seed).standard_normal(shape)
    return Rows(rows.astype(np.float32), int(traffic["request_size"]),
                int(traffic["warmup_requests"]), [("scale", SCALE)])


def prepare(config: dict, data: Rows, device) -> None:
    return None


class Echo:
    def __init__(self, device, dtype=torch.float32):
        self.device, self.dtype, self.scale = device, dtype, 1.0

    def mutate(self, op: tuple) -> None:
        self.scale = float(op[1])

    def query(self, rows: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(rows, device=self.device).to(self.dtype)
        return (x * self.scale).float().cpu().numpy()

    def launches(self) -> int:
        return 0

    def spans(self) -> list:
        return []

    def close(self) -> None:
        pass


def open_system(root, config: dict, data: Rows, prepared, *, device: str,
                traced: bool) -> Echo:
    return Echo(device)


def recorder(run, seed: int):
    def record(i: int, rows: np.ndarray, res) -> tuple[int, tuple]:
        return len(rows), (i, res)

    return record


def judge(run, prepared, seed: int) -> dict:
    err = 0.0
    for i, got in run.kept:
        want = SCALE * run.data.request(i).astype(np.float64)
        err = max(err, np.inf if got is None else
                  float(np.abs(got - want).max()))
    return {"max_err": err}


def control(run, prepared) -> tuple[Echo, int]:
    """The stand-in in bfloat16, one precision step below f32."""
    ctl = Echo(run.device, torch.bfloat16)
    ctl.mutate(("scale", SCALE))
    return ctl, 4
