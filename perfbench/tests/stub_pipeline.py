"""A pipeline that runs no program, for the CPU test that a configuration
of another kind runs through run.run_cell with files of its own: each pass
counts the scene's views, and its one check number is the program's
``gap``, which a test's fault can raise."""

from __future__ import annotations

import types


class Pipeline:
    ORDER = ("gap", "answers_missing")
    ATTEMPTED = "views"

    def __init__(self, config, traffic, scene_dir, views, seed, work, device, spans, overrides=None):
        self.program = types.SimpleNamespace(gap=float(config["gap"]), passes=0)
        self.n_views = len(views["images"])

    def warm(self) -> None:
        pass

    def run_pass(self, seed: int) -> dict:
        self.program.passes += 1
        return {"views": self.n_views}

    def counters(self) -> dict:
        return {"passes": self.program.passes}

    def context(self) -> dict:
        return {}

    def close(self) -> None:
        self.gap = self.program.gap
        self.program = None

    def check(self, params: dict, control: bool = False) -> tuple:
        return {"gap": self.gap, "answers_missing": 0}, ({"gap": 1.0} if control else None)
