"""Summarize a jax.profiler trace (--profile-dir output) by device op: the
trace-backed account of where kernel time goes.

Usage: python bench/trace_report.py PROFILE_DIR [PLANE_PREFIX]
Reads the newest plugins/profile/*/*.xplane.pb under PROFILE_DIR with
jax.profiler.ProfileData (nothing beyond jax) and prints, for every plane
whose name starts with PLANE_PREFIX (default "/device:", the GPU planes),
each line's event count, summed duration and top ops. Exits 1 when no
such plane has events.
"""

import collections
import glob
import os
import sys


def newest_xplane(root: str) -> str:
    pbs = sorted(
        glob.glob(os.path.join(root, "plugins", "profile", "*", "*.xplane.pb")),
        key=os.path.getmtime,
    )
    if not pbs:
        raise FileNotFoundError(f"no xplane.pb under {root}")
    return pbs[-1]


def op_totals(path: str, plane_prefix: str = "/device:") -> dict:
    """{plane name: {line name: Counter(op name -> summed ns)}} for the
    planes whose name starts with plane_prefix; lines without events are
    left out."""
    import jax

    data = jax.profiler.ProfileData.from_file(path)
    out = {}
    for plane in data.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        lines = {}
        for line in plane.lines:
            dur = collections.Counter()
            for ev in line.events:
                dur[ev.name] += ev.duration_ns
            if dur:
                lines[line.name] = dur
        if lines:
            out[plane.name] = lines
    return out


def report(totals: dict, top: int = 10) -> str:
    rows = []
    for plane, lines in totals.items():
        rows.append(f"== {plane}")
        for line, dur in lines.items():
            rows.append(
                f"-- {line}: {len(dur)} ops, {sum(dur.values()) / 1e6:.3f} ms"
            )
            for name, d in dur.most_common(top):
                rows.append(f"   {d / 1e6:9.3f} ms  {name[:110]}")
    return "\n".join(rows)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    prefix = argv[1] if len(argv) > 1 else "/device:"
    path = newest_xplane(argv[0])
    totals = op_totals(path, prefix)
    if not totals:
        print(f"no events on planes {prefix}* in {path}", file=sys.stderr)
        return 1
    print(f"trace: {path}")
    print(report(totals))
    return 0


if __name__ == "__main__":
    sys.exit(main())
