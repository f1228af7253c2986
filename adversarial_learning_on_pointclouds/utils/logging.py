"""Structured training logs (SURVEY.md §5 "Metrics / logging").

The reference prints ``[epoch: batch/num] train loss: x accuracy: y`` per
batch. ``MetricLogger`` keeps that stdout format (``--quiet`` trims it to
reference parity), appends every scalar to a CSV, and — when TensorBoard
is importable — mirrors them as TB scalars. Also computes the headline
points/sec/chip meter (``BASELINE.json:2``).
"""

from __future__ import annotations

import collections
import csv
import os
import sys
import time
from typing import Dict, Optional


def start_host_fetch(values: Dict[str, "object"]) -> Dict[str, "object"]:
    """Kick off non-blocking device->host copies for every dict value.

    The copies queue behind the step's compute and land while later
    launches execute; by materialization time the values are
    host-resident and the whole group reads back in ~one round trip
    instead of one PER value (each blocking ``float()`` of a device
    scalar pays a full host<->device round trip). Shared by the metric
    logger's pipelined rows and eval's per-batch outputs."""
    for v in values.values():
        fetch = getattr(v, "copy_to_host_async", None)
        if fetch is not None:
            fetch()
    return values


class MetricLogger:
    """``lag`` defers metric device->host readbacks: ``log_step`` enqueues
    the step's (still on-device) metric scalars and only materializes
    (``float()``) a row once ``lag`` newer steps have been enqueued, so the
    blocking readback of step N overlaps steps N+1..N+lag already executing
    on the device. Per-step readbacks otherwise serialize the pipeline —
    each ``float()`` pays a full host<->device round trip while the
    device sits idle. Rows print/append in order,
    just ``lag`` steps late; ``lag=0`` restores strictly-synchronous
    per-batch prints (the reference's behavior)."""

    def __init__(self, out_dir: str, run_name: str = "train",
                 quiet: bool = False, tensorboard: bool = False,
                 lag: int = 2):
        os.makedirs(out_dir, exist_ok=True)
        self.quiet = quiet
        self.lag = max(int(lag), 0)
        self._pending: collections.deque = collections.deque()
        self.csv_path = os.path.join(out_dir, f"{run_name}_metrics.csv")
        self._csv_file = open(self.csv_path, "a", newline="")
        self._csv: Optional[csv.DictWriter] = None
        # Per-epoch summaries get their own CSV (mIoU/acc/train_s/...):
        # the per-step file has a different schema, and epoch rows are
        # the ones post-hoc analysis actually reads.
        self.epoch_csv_path = os.path.join(out_dir,
                                           f"{run_name}_epochs.csv")
        self._epoch_csv_file = open(self.epoch_csv_path, "a", newline="")
        self._epoch_csv: Optional[csv.DictWriter] = None
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(os.path.join(out_dir, "tb"))
            except Exception:
                self._tb = None
        self._step_t0 = time.perf_counter()

    _start_fetch = staticmethod(start_host_fetch)

    def _emit(self, rows, metrics, headers) -> None:
        """Materialize one launch group: ``rows``/``headers`` are lists
        (length 1 for single steps, K for a scan launch); ``metrics``
        values are scalars or [K] arrays indexed per row."""
        import numpy as np
        arrs = {k: np.asarray(v) for k, v in metrics.items()}
        for i, (row, header) in enumerate(zip(rows, headers)):
            vals = {k: float(a[i] if a.ndim else a)
                    for k, a in arrs.items()}
            row.update(vals)
            if self._csv is None:
                self._csv = csv.DictWriter(self._csv_file,
                                           fieldnames=row.keys())
                if self._csv_file.tell() == 0:
                    self._csv.writeheader()
            self._csv.writerow(row)
            if self._tb is not None:
                for k, v in row.items():
                    if k not in ("epoch", "batch", "step"):
                        self._tb.add_scalar(k, v, row["step"])
            if not self.quiet:
                parts = " ".join(f"{k}: {v:.6f}" for k, v in vals.items())
                print(f"{header} {parts}")
        if not self.quiet:
            sys.stdout.flush()

    def _drain(self, keep: int) -> None:
        while len(self._pending) > keep:
            self._emit(*self._pending.popleft())

    def log_step(self, epoch: int, batch: int, num_batches: int, step: int,
                 metrics: Dict[str, float], points_per_step: int = 0,
                 num_chips: int = 1) -> None:
        now = time.perf_counter()
        dt = now - self._step_t0
        self._step_t0 = now
        # NB with lag > 0 the interval is enqueue-to-enqueue; under a
        # saturated device pipeline that still equals the steady-state
        # per-step wall time.
        row = {"epoch": epoch, "batch": batch, "step": step,
               "step_time_s": round(dt, 5)}
        if points_per_step:
            row["points_per_sec_per_chip"] = round(
                points_per_step / dt / num_chips, 1)
        self._pending.append(([row], self._start_fetch(dict(metrics)),
                              [f"[{epoch}: {batch}/{num_batches}]"]))
        self._drain(self.lag)

    def log_scan_steps(self, epoch: int, batch0: int, num_batches: int,
                       step_end: int, metrics: Dict[str, "object"], k: int,
                       points_per_step: int = 0, num_chips: int = 1) -> None:
        """Log K steps executed by one fused ``lax.scan`` launch.

        ``metrics`` values carry a leading K axis; one elapsed interval is
        split evenly over the K rows (the launch is one program). The K
        rows enqueue as ONE pending group — the [K] metric arrays transfer
        whole (never indexed on device, which would dispatch a tiny
        program per element) and ``lag`` counts launches."""
        now = time.perf_counter()
        dt = (now - self._step_t0) / max(k, 1)
        self._step_t0 = now
        rows, headers = [], []
        for i in range(k):
            row = {"epoch": epoch, "batch": batch0 + i,
                   "step": step_end - k + 1 + i,
                   "step_time_s": round(dt, 5)}
            if points_per_step:
                row["points_per_sec_per_chip"] = round(
                    points_per_step / dt / num_chips, 1)
            rows.append(row)
            headers.append(f"[{epoch}: {batch0 + i}/{num_batches}]")
        self._pending.append((rows, self._start_fetch(dict(metrics)),
                              headers))
        self._drain(self.lag)

    def log_epoch(self, epoch: int, **scalars: float) -> None:
        self._drain(0)
        parts = " ".join(f"{k}: {v:.6f}" for k, v in scalars.items())
        print(f"[epoch {epoch}] {parts}")
        row = {"epoch": epoch, **{k: float(v) for k, v in scalars.items()}}
        if self._epoch_csv is None:
            self._epoch_csv = csv.DictWriter(self._epoch_csv_file,
                                             fieldnames=row.keys())
            if self._epoch_csv_file.tell() == 0:
                self._epoch_csv.writeheader()
        self._epoch_csv.writerow(row)
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f"epoch/{k}", v, epoch)
        sys.stdout.flush()

    def close(self) -> None:
        self._drain(0)
        self._csv_file.close()
        self._epoch_csv_file.close()
        if self._tb is not None:
            self._tb.close()
