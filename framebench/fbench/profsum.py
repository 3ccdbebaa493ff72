"""A summary of a torch.profiler trace of some frames, for the per-layer
metrics' readers and the result line's `breakdown`.

Device events are sorted by name into the port's hand-written kernels
(csrc/: K1-K5, by the kernel function names of their .cu files) and the
rest, PyTorch's own kernels of the torch-op glue; copies and fills
(Memcpy / Memset) are device work of neither.  The device's busy time is
the union of all their intervals; an idle gap is labelled by what the host
was doing in it: the innermost host-side span or operator running at the
gap's middle (runtime API calls skipped).  The profiler arithmetic follows
rtrt_tpu_torch/tools/profile_frame.py::device_busy (a copy, extended to
the timeline).
"""

from __future__ import annotations

import bisect
import dataclasses
import re

# the kernel functions of the port's csrc/ kernels K1-K5, as the profiler
# names their instantiations ("void megakernel<32, 0, ...>(...)")
CSRC_KERNELS = ("traverse_kernel", "megakernel", "post_tail_kernel",
                "denoise_wide_kernel", "reproject_kernel")
_CSRC = re.compile(r"\b(" + "|".join(CSRC_KERNELS) + r")\b")
_COPY = re.compile(r"^(Memcpy|Memset)")


@dataclasses.dataclass
class Summary:
    """frames: the frames traced; window_s: the traced window's length;
    busy_s: the union of the device's busy intervals in it; kernels: [(name,
    seconds)] for each kernel launch; copies: [(name, seconds)] for each
    copy or fill; gaps: [(label, seconds)] of the idle gaps."""

    frames: int
    window_s: float
    busy_s: float
    kernels: list
    copies: list
    gaps: list

    def kernel_s(self, pattern: str | None = None, csrc: bool | None = None):
        """Device seconds of the kernels whose name matches the regular
        expression `pattern` (None: any), of the csrc/ kernels (csrc=True),
        or of the others (csrc=False)."""
        return sum(s for n, s in self._select(pattern, csrc))

    def launches(self, pattern: str | None = None,
                 csrc: bool | None = None) -> int:
        return len(self._select(pattern, csrc))

    def _select(self, pattern, csrc):
        rx = None if pattern is None else re.compile(pattern)
        return [(n, s) for n, s in self.kernels
                if (rx is None or rx.search(n))
                and (csrc is None or bool(_CSRC.search(n)) == csrc)]

    def top_ops(self, n: int = 10):
        """[[name, seconds]] of the device operations that took most time,
        summed by name."""
        return _top(self.kernels + self.copies, n)

    def top_gaps(self, n: int = 10):
        """[[label, seconds]] of the idle gaps, summed by label."""
        return _top(self.gaps, n)


def _top(pairs, n):
    tot = {}
    for name, s in pairs:
        tot[name] = tot.get(name, 0.0) + s
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def summarize(events, frames: int) -> Summary:
    """Summary of a profiler's `events()` over `frames` frames.  Device
    events are those whose device_type is CUDA; host events the rest."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA and (
                getattr(e, "is_user_annotation", False)
                or e.name.startswith("fbench.")):
            continue  # a host span's shadow on the device timeline
        if e.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        else:
            host.append((tr.start, tr.end, e.name, e.thread))
    if not dev:
        return Summary(frames, 0.0, 0.0, [], [], [])
    dev.sort()
    kernels = [(n, (b - a) * 1e-6) for a, b, n in dev if not _COPY.match(n)]
    copies = [(n, (b - a) * 1e-6) for a, b, n in dev if _COPY.match(n)]
    busy, gaps = [], []
    cur_a, cur_b = dev[0][0], dev[0][1]
    for a, b, _ in dev[1:]:
        if a > cur_b:
            busy.append((cur_a, cur_b))
            gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy.append((cur_a, cur_b))
    # the host's call tree: the thread that ran the frames
    main = {h[3] for h in host if h[2] == "fbench.frame"}
    spans = [h[:3] for h in host if (not main or h[3] in main)
             and not h[2].startswith("cuda")]
    t0 = min([dev[0][0]] + [h[0] for h in spans if h[2].startswith("fbench")])
    t1 = max(cur_b, max([h[1] for h in spans] or [cur_b]))
    labels = _stab(spans, [(a + b) / 2 for a, b in gaps])
    return Summary(
        frames=frames, window_s=(t1 - t0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6, kernels=kernels,
        copies=copies,
        gaps=[(lab, (b - a) * 1e-6) for lab, (a, b) in zip(labels, gaps)])


def _stab(spans, points):
    """For each point (in any order), the name of the innermost span that
    contains it, or "idle host" where none does.  Host spans nest (one
    thread's call tree), so a sweep with a stack finds the innermost."""
    order = sorted(range(len(points)), key=points.__getitem__)
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    starts = [s[0] for s in spans]
    out = ["idle host"] * len(points)
    stack, i = [], 0
    for k in order:
        t = points[k]
        j = bisect.bisect_right(starts, t)
        while i < j:
            s = spans[i]
            while stack and stack[-1][1] < s[0]:
                stack.pop()
            stack.append(s)
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out[k] = stack[-1][2]
    return out
