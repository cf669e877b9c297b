#!/usr/bin/env python
"""Timeline view of one window of an xplane capture: prints events of the
'XLA Ops' line in offset order with [begin, end] so serialization vs
overlap between the periodic phase's gather/scatter fusions is visible
(xplane_ops.py only prints duration sums, which cannot distinguish them).

Usage: python tools/xplane_timeline.py [capture.xplane.pb] [t0_ms] [t1_ms]
Defaults: newest capture under /tmp/grmonty_profile, a 25 ms window
starting 1/3 into the capture (mid-slice, steady state).
"""

import glob
import sys

from xplane_ops import fields, parse_plane, _line_name  # noqa: E402


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("-")]
    path = args[0] if args else None
    if path is None:
        cands = sorted(glob.glob("/tmp/grmonty_profile/**/*.xplane.pb",
                                 recursive=True))
        if not cands:
            sys.exit("no capture found under /tmp/grmonty_profile")
        path = cands[-1]
    buf = open(path, "rb").read()

    for fnum, wt, plane_buf in fields(buf):
        if fnum != 1 or wt != 2:
            continue
        pname, lines, meta = parse_plane(plane_buf)
        if "/device:" not in pname:
            continue
        for lbuf in lines:
            lname = _line_name(lbuf)
            if "XLA Ops" not in lname:
                continue
            evs = []
            for f2, w2, v2 in fields(lbuf):
                if f2 == 4 and w2 == 2:
                    mid = off = d = 0
                    for f3, w3, v3 in fields(v2):
                        if f3 == 1:
                            mid = v3
                        elif f3 == 2:
                            off = v3
                        elif f3 == 3:
                            d = v3
                    evs.append((off, d, meta.get(mid, f"#{mid}")))
            if not evs:
                continue
            evs.sort()
            t_max = max(o + d for o, d, _ in evs)
            if len(args) > 2:
                t0, t1 = float(args[1]) * 1e9, float(args[2]) * 1e9
            else:
                t0 = t_max / 3.0
                t1 = t0 + 25e6 * 1e3  # 25 ms in ps
            print(f"=== {pname} :: '{lname}' window "
                  f"[{t0/1e9:.3f}, {t1/1e9:.3f}] ms of {t_max/1e9:.3f} ===")
            for off, d, name in evs:
                if off + d < t0 or off > t1:
                    continue
                # skip the giant enclosing while ops
                if d > (t1 - t0):
                    print(f"  (encloses window: {name[:80]})")
                    continue
                print(f"[{off/1e9:10.3f} +{d/1e6:8.3f}us] {name[:100]}")
            return


if __name__ == "__main__":
    main()
