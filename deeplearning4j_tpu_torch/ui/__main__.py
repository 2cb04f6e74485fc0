"""Standalone dashboard server: ``python -m deeplearning4j_tpu_torch.ui``
(counterpart of deeplearning4j_tpu/ui/__main__.py).

Parity: the reference ships the UI as an executable with a port flag
(PlayUIServer.java:53, JCommander ``--uiPort``). Two ways to feed it:
- ``--file run.jsonl``: attach persisted FileStatsStorage logs (crash-
  tolerant JSONL written by a training run) — the post-mortem viewer;
- remote mode is always on: training processes post live through
  ``RemoteStatsStorageRouter(url)`` (ui/router.py).
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.ui",
        description="deeplearning4j-tpu training dashboard")
    ap.add_argument("--port", type=int, default=9000,
                    help="HTTP port (0 = ephemeral); PlayUIServer --uiPort")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--file", action="append", default=[],
                    help="attach a FileStatsStorage JSONL (repeatable)")
    args = ap.parse_args(argv)

    from deeplearning4j_tpu_torch.ui import FileStatsStorage, UIServer
    server = UIServer.get_instance(port=args.port, host=args.host)
    for path in args.file:
        server.attach(FileStatsStorage(path))
    print(f"dashboard: {server.url}  "
          f"(POST /api/post for remote stats; Ctrl-C to stop)", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
