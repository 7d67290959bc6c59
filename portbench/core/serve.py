"""The closed loop that serving kinds share: `clients` clients, each
sending its next request when its previous answer is on the device, for
the window; a request counts when its answer came inside the window, and
its latency runs from its sending to its answer.

A kind (portbench/kinds/<kind>.py) gives the loop a server with
request(i) -> (inputs, the program's answer), reference(inputs, precision),
gaps(answer, reference's) -> {number: value} and work() -> Record.work.

`correct`: a sample of the requests sent in the window, drawn from the
seed (`check_requests` of the first `check_pool`, and the last one), is
kept, answers that came after the window's close included; once the
window has closed and the pipeline is freed, the reference recomputes
each in float32 from the same inputs and the server's gaps compare them.
"""

from __future__ import annotations

import collections
import random
import time

import torch

from portbench.core import inputs
from portbench.core.common import Outcome, Record, Run
from portbench.core.trace import capture
from portbench.reference import neraf as ref


def drive(run: Run, server) -> Outcome:
    tr = run.traffic
    rng = random.Random(inputs.key(run.seed, "sample"))
    keep = set(rng.sample(range(tr["check_pool"]), tr["check_requests"]))
    kept, lat, i = {}, [], 0
    cuda = run.device.type == "cuda"
    if run.control:
        # the control: the reference at lower precision in the program's
        # place, on the requests a run keeps
        ref.exact_float32()
        for i in sorted(keep):
            inp, _ = server.request(i)
            kept[i] = (inp, server.answer(server.reference(inp, run.control)))
        setup_s, tr_rec, peak = 0.0, None, 0
    else:
        for w in range(tr["warm_requests"]):
            server.request(-1 - w)
        run.synchronize()
        setup_s = time.perf_counter() - run.started
        tr_rec = None
        if run.trace:
            def traced():
                events = collections.deque()
                for w in range(tr["traced_requests"]):
                    server.request(-100 - w)
                    if cuda:
                        events.append(torch.cuda.Event())
                        events[-1].record()
                        if len(events) >= tr["clients"]:
                            events.popleft().synchronize()
                return tr["traced_requests"]
            tr_rec = capture(traced, run.synchronize)
        end = time.perf_counter() + run.seconds
        pending, last = collections.deque(), None

        def finish(i, t0, inp, out, done):
            nonlocal last
            if done is None:
                run.synchronize()
            else:
                done.synchronize()
            t1 = time.perf_counter()
            if t1 <= end:
                lat.append(t1 - t0)
            # an answer due in the window that comes after it is late, not
            # wrong: it is judged all the same
            if i in keep:
                kept[i] = (inp, out)
            last = (i, inp, out)

        while (t0 := time.perf_counter()) < end:
            inp, out = server.request(i)
            done = torch.cuda.Event() if cuda else None
            if done is not None:
                done.record()
            pending.append((i, t0, inp, out, done))
            if len(pending) >= tr["clients"]:
                finish(*pending.popleft())
            i += 1
        while pending:
            finish(*pending.popleft())
        if last is not None:
            kept.setdefault(last[0], last[1:])
        peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
        server.pipe = None
        if cuda:
            torch.cuda.empty_cache()
    ref.exact_float32()
    worst, notes = {}, []
    for idx, (inp, out) in sorted(kept.items()):
        want = server.reference(inp, None)
        for k, v in server.gaps(out, want).items():
            notes.append(f"request {idx}: {k} {v:.6g}")
            worst[k] = max(worst.get(k, 0.0), v)
        del want
    if not worst:
        worst = {k: float("inf") for k in run.limits}
        notes.append("no request finished in the window")
    rec = Record(seconds=run.seconds, units=len(lat), latencies_s=lat, setup_s=setup_s,
                 work=server.work(), trace=tr_rec)
    return Outcome(record=rec, memory_peak=peak, notes=notes, readings=worst,
                   checks=[(k, worst[k], run.limits[k]) for k in sorted(run.limits)])
