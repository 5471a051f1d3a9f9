"""Host milliseconds a K1 call spends before and after its launch: the
program's ``kernel.siren_loss_grads`` span less its ``kernel.launch`` span
on the same thread (the checks, the route, the allocations and the pointer
arrays, none of which waits on the launch queue), over the calls that
launched a kernel."""
import bisect
from collections import defaultdict

from portbench.metrics import _program


def read(run):
    recorded = _program.spans(run)
    if not recorded:
        return None
    launches = defaultdict(list)
    for s in _program.named(recorded, "kernel.launch"):
        launches[s.thread].append((s.start_ns, s.end_ns))
    for v in launches.values():
        v.sort()
    total, n = 0, 0
    for call in _program.named(recorded, "kernel.siren_loss_grads"):
        mine = launches.get(call.thread, [])
        i = bisect.bisect_left(mine, (call.start_ns, 0))
        inside = 0
        while i < len(mine) and mine[i][1] <= call.end_ns:
            inside += mine[i][1] - mine[i][0]
            i += 1
        if inside:
            total += call.end_ns - call.start_ns - inside
            n += 1
    return total / n / 1e6 if n else None
