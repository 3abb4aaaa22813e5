"""Per-pair result telemetry (sqlite).

Port of gtsfm_tpu/common/telemetry.py, with its schema: the two-view
results (one row per pair), stage timings and run metadata of a run, in a
sqlite file. ``SceneOptimizer`` writes them when
``SceneOptimizerOptions.telemetry_db`` names the file. Host code; sqlite3
is in Python's standard library.
"""

from __future__ import annotations

import json
import os
import sqlite3
import time
from typing import Optional


class TelemetryDB:
    """Append-only run telemetry. Connections are opened lazily per use so
    the object is trivially picklable (the reference's DaskDBModuleBase
    strips live connections before shipping to workers for the same
    reason)."""

    def __init__(self, path: str = "results/telemetry.sqlite", run_id: Optional[str] = None):
        self.path = path
        self.run_id = run_id or time.strftime("%Y%m%d_%H%M%S")

    def __getstate__(self):
        return {"path": self.path, "run_id": self.run_id}

    def __setstate__(self, state):
        self.__dict__.update(state)

    def _conn(self):
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        conn = sqlite3.connect(self.path, timeout=10)
        conn.execute(
            """CREATE TABLE IF NOT EXISTS two_view_results (
                run_id TEXT, ts REAL, i1 INTEGER, i2 INTEGER,
                num_matches INTEGER, num_inliers INTEGER,
                inlier_ratio REAL, valid INTEGER,
                r_error_deg REAL, u_error_deg REAL)"""
        )
        conn.execute(
            """CREATE TABLE IF NOT EXISTS stage_timings (
                run_id TEXT, ts REAL, stage TEXT, seconds REAL)"""
        )
        conn.execute(
            """CREATE TABLE IF NOT EXISTS run_metadata (
                run_id TEXT, ts REAL, key TEXT, value TEXT)"""
        )
        return conn

    def log_two_view_results(self, reports) -> None:
        conn = self._conn()
        now = time.time()
        conn.executemany(
            "INSERT INTO two_view_results VALUES (?,?,?,?,?,?,?,?,?,?)",
            [
                (
                    self.run_id, now, r.i1, r.i2, r.num_matches, r.num_inliers,
                    r.inlier_ratio, int(r.valid), r.R_error_deg, r.U_error_deg,
                )
                for r in reports
            ],
        )
        conn.commit()
        conn.close()

    def log_stage(self, stage: str, seconds: float) -> None:
        conn = self._conn()
        conn.execute(
            "INSERT INTO stage_timings VALUES (?,?,?,?)",
            (self.run_id, time.time(), stage, seconds),
        )
        conn.commit()
        conn.close()

    def log_metadata(self, **kwargs) -> None:
        conn = self._conn()
        now = time.time()
        conn.executemany(
            "INSERT INTO run_metadata VALUES (?,?,?,?)",
            [(self.run_id, now, k, json.dumps(v)) for k, v in kwargs.items()],
        )
        conn.commit()
        conn.close()

    def query(self, sql: str, args=()) -> list:
        conn = self._conn()
        out = conn.execute(sql, args).fetchall()
        conn.close()
        return out
