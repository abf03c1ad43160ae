"""artifacts CLI (a copy of the host-only ``fv3net_tpu/artifacts/cli.py``,
console script ``fv3net-artifacts-torch``; reference: external/artifacts/fv3net/artifacts/cli.py —
query experiment outputs by the bucket/project/date-tag convention and
list StepMetadata provenance)."""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys

from fv3net_torch.artifacts.resolve_url import resolve_url


def _resolve(args) -> int:
    when = (
        datetime.date.fromisoformat(args.date) if args.date else None
    )
    print(resolve_url(args.bucket, args.project, args.tag, when))
    return 0


def _ls(args) -> int:
    """List experiment outputs under a workspace root laid out by
    resolve_url (bucket/project/date/tag)."""
    root = args.bucket
    if not os.path.isdir(root):
        print(f"no such workspace {root}", file=sys.stderr)
        return 1
    rows = []
    for project in sorted(os.listdir(root)):
        pdir = os.path.join(root, project)
        if not os.path.isdir(pdir):
            continue
        if args.project and project != args.project:
            continue
        for date in sorted(os.listdir(pdir)):
            ddir = os.path.join(pdir, date)
            if not os.path.isdir(ddir):
                continue
            for tag in sorted(os.listdir(ddir)):
                rows.append(
                    {"project": project, "date": date, "tag": tag,
                     "path": os.path.join(ddir, tag)}
                )
    for r in rows:
        if args.output == "json":
            print(json.dumps(r))
        else:
            print(r["project"], r["date"], r["tag"], r["path"])
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fv3net-artifacts")
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("resolve-url", help="standard output URL for a run")
    r.add_argument("bucket")
    r.add_argument("project")
    r.add_argument("tag")
    r.add_argument("--date", default=None)
    r.set_defaults(fn=_resolve)
    ls = sub.add_parser("ls", help="list experiment outputs in a workspace")
    ls.add_argument("bucket")
    ls.add_argument("--project", default=None)
    ls.add_argument("-o", "--output", default="", choices=["", "json"])
    ls.set_defaults(fn=_ls)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
