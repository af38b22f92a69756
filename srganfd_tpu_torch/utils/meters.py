"""stdout progress meters (the port's own copy of
``srganfd_tpu/utils/meters.py``).

Parity target: ``AverageMeter``/``ProgressMeter``/``Summary``
(``ESRGAN/utils.py:104-168``), the reference's wall-clock meters, with the
same display surface.
"""

from __future__ import annotations

import enum


class Summary(enum.Enum):
    NONE = 0
    AVERAGE = 1
    SUM = 2
    COUNT = 3


class AverageMeter:
    def __init__(self, name: str, fmt: str = ":f", summary_type: Summary = Summary.AVERAGE):
        self.name = name
        self.fmt = fmt
        self.summary_type = summary_type
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self) -> str:
        return ("{name} {val" + self.fmt + "} ({avg" + self.fmt + "})").format(
            name=self.name, val=self.val, avg=self.avg
        )

    def summary(self) -> str:
        if self.summary_type is Summary.NONE:
            return ""
        if self.summary_type is Summary.AVERAGE:
            return f"{self.name} {self.avg:.4f}"
        if self.summary_type is Summary.SUM:
            return f"{self.name} {self.sum:.4f}"
        return f"{self.name} {self.count}"


class ProgressMeter:
    def __init__(self, num_batches: int, meters: list[AverageMeter], prefix: str = ""):
        num_digits = len(str(num_batches))
        self.batch_fmtstr = "[" + ("{:" + str(num_digits) + "d}") + "/" + str(num_batches) + "]"
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int) -> None:
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        print("\t".join(entries), flush=True)

    def display_summary(self) -> None:
        entries = [" *"] + [m.summary() for m in self.meters if m.summary()]
        print(" ".join(entries), flush=True)
