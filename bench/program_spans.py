"""The program's own spans in a profiled window, for the readers that use them.

The system names its layer boundaries ``rt.<layer>.<part>``
(``repro_torch.obs``). While a profiler runs, each span is a host-side
range of the profiler's (a ``FUNCTION``-scope record): it sits on the CPU
timeline beside the ops it encloses, on the kernels' clock, and draws
nothing on the device's timeline, so ``trace.Window`` counts no span as a
device operation.

``of(rec)`` walks the window's events once and keeps the result on
``rec``. Device time goes to the span that launched it: each CPU op's
kernels go to its innermost ``rt.`` ancestor. An op whose nearest such
ancestor is an ``autograd::engine::evaluate_function`` event is backward
work: its kernels go to the span of the forward op with the same
``(sequence_nr, thread)``; a remat's recompute meets its own re-entered
spans first and keeps them. A device event named as the op it links to is
that op's range on the device, not a kernel. The profiler lists a kernel
under every host event that shares its op's correlation id (the op, and
CUPTI's events inside its launch), so each id's kernels are counted once,
under the first of those events that is an op (``launches``). Where the
window holds no ``rt.`` event (a system without spans), or the kernels put
down come to more than the window's (counted twice), ``of`` gives None and
so does every reader that uses it.
"""

from __future__ import annotations

import json
import re
from typing import Optional

RT = "rt."
BACKWARD = "autograd::engine::evaluate_function"
#: host events that are no op: CUDA API calls (`cuda*`, `cu*`) and CUPTI's bookkeeping (a launch that
#: found the command buffer full, ...). Where one shares an op's correlation id, the op takes the kernels
NOT_OPS = re.compile(r"^((cuda|cu)[A-Z]|Command Buffer Full$|Activity Buffer Request$|Buffer Flush$"
                     r"|Runtime Triggered Module Loading$|Lazy Function Loading$|Instrumentation$|Resource$)")


def launches(e) -> bool:
    """Whether host event ``e`` is an op: no runtime call or CUPTI event,
    and inside none."""
    parent = e.cpu_parent
    return not NOT_OPS.match(e.name) and not (parent is not None and NOT_OPS.match(parent.name))


def _owner(e, memo: dict):
    """The innermost ``rt.`` or evaluate_function event at or above ``e``."""
    seen = []
    while e is not None:
        key = id(e)
        if key in memo:
            hit = memo[key]
            break
        seen.append(key)
        if e.name.startswith(RT) or e.name.startswith(BACKWARD):
            hit = e
            break
        e = e.cpu_parent
    else:
        hit = None
    for key in seen:
        memo[key] = hit
    return hit


def rt_parent(e):
    """The innermost ``rt.`` event strictly above ``e`` on its thread."""
    e = e.cpu_parent
    while e is not None and not e.name.startswith(RT):
        e = e.cpu_parent
    return e


def dur_us(e) -> float:
    return e.time_range.end - e.time_range.start


def attribution(cpu):
    """``put(op)``: (the span that takes ``op``'s kernels, or None and where
    they came from) over the CPU events ``cpu``."""
    memo: dict = {}
    forward = {}  # (sequence_nr, thread) of a forward op -> its span's name
    for e in cpu:
        if e.sequence_nr >= 0 and not e.name.startswith(BACKWARD):
            own = _owner(e, memo)
            if own is not None and own.name.startswith(RT):
                forward.setdefault((e.sequence_nr, e.thread), own.name)

    def put(e):
        own = _owner(e, memo)
        if own is None:
            return None, e.name
        if own.name.startswith(RT):
            return own.name, None
        return forward.get((own.sequence_nr, own.fwd_thread)), own.name[len(BACKWARD) + 2:]

    return put


def walk(events) -> Optional[dict]:
    """The program's spans in ``events``: ``spans``, {name: {count, host_us,
    self_us, device_us}} (self: host time outside the spans inside it),
    device time put down as the module's docstring says; ``unspanned``, the
    device time no span took, by the op or backward node it came from; and
    ``events``, {name: [its profiler events]}. None without an ``rt.``
    event."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU and not e.is_async]
    by_name: dict = {}
    for e in cpu:
        if e.name.startswith(RT):
            by_name.setdefault(e.name, []).append(e)
    if not by_name:
        return None
    table = {k: {"count": len(v), "host_us": sum(map(dur_us, v)), "self_us": sum(map(dur_us, v)),
                 "device_us": 0.0} for k, v in by_name.items()}
    for evs in by_name.values():
        for e in evs:
            up = rt_parent(e)
            if up is not None:
                table[up.name]["self_us"] -= dur_us(e)
    put = attribution(cpu)
    owner: dict = {}  # correlation id -> the host event that takes its kernels
    for e in cpu:
        if any(k.name != e.name for k in e.kernels):
            held = owner.get(e.id)
            if held is None or (launches(e) and not launches(held)):
                owner[e.id] = e
    unspanned: dict = {}
    for e in owner.values():
        kernels = [k.duration for k in e.kernels if k.name != e.name]
        if kernels:
            name, where = put(e)
            if name is None:
                unspanned[where] = unspanned.get(where, 0.0) + sum(kernels)
            else:
                table[name]["device_us"] += sum(kernels)
    return {"spans": table, "unspanned": unspanned, "events": by_name}


def gaps(win, n: int = 10) -> list:
    """The window's ``n`` longest device-idle gaps inside the harness's
    spans (as ``trace.Window.idle_gaps``), each named by the innermost
    program span open at its middle on each thread, the thread that ran
    the most ``rt.train.step`` time first."""
    from torch.autograd import DeviceType

    ranges = [(e.thread, e.name, e.time_range.start, e.time_range.end) for e in win._prof.events()
              if e.device_type == DeviceType.CPU and e.name.startswith(RT)]
    if not win._spans or not ranges:
        return []
    steps: dict = {}
    for t, name, a, b in ranges:
        if name == "rt.train.step":
            steps[t] = steps.get(t, 0.0) + b - a
    lo, hi = min(a for _n, a, _b in win._spans), max(b for _n, _a, b in win._spans)
    edges = [lo] + [x for iv in win._merged for x in iv] + [hi]
    found = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                    if edges[i + 1] > edges[i] and lo <= edges[i] < hi), reverse=True)[:n]
    out = []
    for length, start in found:
        mid = start + length / 2
        inner: dict = {}
        for t, name, a, b in ranges:
            if a <= mid <= b and (t not in inner or a > inner[t][0]):
                inner[t] = (a, name)
        order = sorted(inner, key=lambda t: -steps.get(t, 0.0))
        out.append([" | ".join(inner[t][1] for t in order) or "(none)", length / 1e6])
    return out


def of(rec) -> Optional[dict]:
    """The walk of ``rec``'s profiled window, made once and logged as one
    ``spans`` line: per span name its count and host, self and device ms a
    step; the device time no span took; the share of the window's device
    time that spans took; and the longest idle gaps by span. None, with
    ``counted_twice`` on the line, where the kernels put down to host events
    come to more than the window's own."""
    if hasattr(rec, "_program_spans"):
        return rec._program_spans
    win = getattr(rec, "window", None)
    got = walk(win._prof.events()) if win is not None else None
    if got is not None:
        total = sum(b - a for _n, a, b in win.kernels)
        put = sum(r["device_us"] for r in got["spans"].values())
        got["covered"] = put / total if total > 0 else None
        # kernels linked to no host op: launched from a thread the profiler does not follow
        rest = total - put - sum(got["unspanned"].values())
        got["unspanned"]["(no host op)"] = rest
        twice = rest < -1e-6 * max(total, 1.0)
        got["gaps"] = gaps(win)
        per = 1e3 * rec.steps
        print(json.dumps({"bench": "spans", "steps": rec.steps, "covered": got["covered"], "counted_twice": twice,
                          "by_name": {k: {"count": r["count"], "host_ms": r["host_us"] / per,
                                          "self_ms": r["self_us"] / per, "device_ms": r["device_us"] / per}
                                      for k, r in sorted(got["spans"].items())},
                          "unspanned_ms": {k: v / per for k, v in sorted(got["unspanned"].items(),
                                                                          key=lambda kv: -kv[1])[:8]},
                          "idle_gaps": got["gaps"]}), flush=True)
        if twice:
            got = None
    rec._program_spans = got
    return got


def device_ms(rec, *names: str) -> Optional[float]:
    """Device ms a step put down to the spans ``names``; None where the
    window saw no device work or no span."""
    got = card(rec)
    if got is None:
        return None
    return sum(got["spans"].get(n, {}).get("device_us", 0.0) for n in names) / (1e3 * rec.steps)


def card(rec) -> Optional[dict]:
    """``of(rec)`` for a reader: None where the window saw no device work
    (a CPU run: no kernels, and no device for a host span to wait on) or no
    span."""
    got = of(rec)
    return None if got is None or rec.window.busy_s <= 0 else got
