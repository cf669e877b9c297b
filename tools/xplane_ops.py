#!/usr/bin/env python
"""Minimal XSpace (xplane.pb) reader: top device ops by total duration.

The tensorboard_plugin_profile converter in this image is broken
(tf _pywrap_profiler lacks xspace_to_tools_data, and no xplane_pb2 is
importable), so this decodes the protobuf wire format directly against
the stable XPlane schema (tsl/profiler/protobuf/xplane.proto):

    XSpace   { repeated XPlane planes = 1; }
    XPlane   { id=1; name=2; repeated XLine lines=3;
               map<int64,XEventMetadata> event_metadata=4; }
    XLine    { id=1; name=2; repeated XEvent events=4; }
    XEvent   { metadata_id=1; offset_ps=2; duration_ps=3; }
    XEventMetadata { id=1; name=2; display_name=4; }

Usage: python tools/xplane_ops.py [capture.xplane.pb] [n_top]
Defaults to the newest capture under /tmp/grmonty_profile.
"""

import glob
import struct
import sys
from collections import defaultdict


def _varint(buf, pos):
    res = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        res |= (b & 0x7F) << shift
        if not b & 0x80:
            return res, pos
        shift += 7


def fields(buf):
    """Yield (field_number, wire_type, value) over one message's bytes."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _varint(buf, pos)
        fnum, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _varint(buf, pos)
        elif wt == 1:
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wt == 2:
            ln, pos = _varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"wire type {wt}")
        yield fnum, wt, val


def _line_name(buf):
    for fnum, wt, val in fields(buf):
        if fnum == 2 and wt == 2:
            return val.decode("utf-8", "replace")
    return ""


def parse_plane(buf):
    name = ""
    lines = []
    meta = {}
    for fnum, wt, val in fields(buf):
        if fnum == 2 and wt == 2:
            name = val.decode("utf-8", "replace")
        elif fnum == 3 and wt == 2:
            lines.append(val)
        elif fnum == 4 and wt == 2:
            # map entry { int64 key=1; XEventMetadata value=2; }
            k = v = None
            for f2, w2, v2 in fields(val):
                if f2 == 1:
                    k = v2
                elif f2 == 2:
                    v = v2
            if v is not None:
                mname = ""
                for f3, w3, v3 in fields(v):
                    if f3 == 2 and w3 == 2:
                        mname = v3.decode("utf-8", "replace")
                meta[k] = mname
    return name, lines, meta


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("-")]
    path = args[0] if args else None
    n_top = int(args[1]) if len(args) > 1 else 30
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
            dur = defaultdict(int)
            cnt = defaultdict(int)
            total = 0
            for f2, w2, v2 in fields(lbuf):
                if f2 == 4 and w2 == 2:  # XEvent
                    mid = d = 0
                    for f3, w3, v3 in fields(v2):
                        if f3 == 1:
                            mid = v3
                        elif f3 == 3:
                            d = v3
                    name = meta.get(mid, f"#{mid}")
                    dur[name] += d
                    cnt[name] += 1
                    total += d
            if not dur:
                continue
            print(f"=== {pname} :: line '{lname}'  (sum {total/1e9:.3f} ms; "
                  f"async ops overlap, so sums can exceed wall) ===")
            for name, d in sorted(dur.items(), key=lambda kv: -kv[1])[:n_top]:
                print(f"{d/1e9:10.3f} ms {cnt[name]:7d}x  "
                      f"{100.0*d/max(total,1):5.1f}%  {name[:110]}")


if __name__ == "__main__":
    main()
