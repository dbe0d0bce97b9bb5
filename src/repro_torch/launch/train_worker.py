"""A training rank: ranks 1..R-1 of a ``launch.mesh.TrainMesh``.

    python -m repro_torch.launch.train_worker --rank R --devices D0,D1,... \\
        --port P --backend gloo --data D --model M

``make_train_mesh`` starts it; nobody else should. It joins rank 0's
group, then runs the jobs rank 0 pickles into its stdin, in order, until
the pipe closes: ``("run", module, name, layout, args, kwargs)`` runs
``module.name(mesh, *args, **kwargs)`` under ``layout`` (data, model),
as rank 0 runs it at the same time (SPMD), and sends the result back to
rank 0. An error ends the process with its traceback on stderr; its
peers' next collective then fails.
"""
from __future__ import annotations

import argparse
import importlib
import sys
from typing import List, Optional

import torch

from repro_torch.launch.mesh import TrainMesh, read_commands, run_job


def serve(mesh: TrainMesh, commands) -> None:
    """Run rank 0's jobs (an iterator of tuples) to their end."""
    for msg in commands:
        if msg[0] != "run":
            raise ValueError(f"unknown command {msg[0]!r}")
        _, module, name, layout, args, kwargs = msg
        fn = getattr(importlib.import_module(module), name)
        mesh.send_obj(run_job(mesh, fn, layout, args, kwargs), 0)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--devices", required=True)
    ap.add_argument("--backend", required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--data", type=int, required=True)
    ap.add_argument("--model", type=int, required=True)
    args = ap.parse_args(argv)
    devices = args.devices.split(",")
    device = torch.device(devices[args.rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = TrainMesh.join(args.rank, devices, args.backend, args.port,
                          args.data, args.model)
    serve(mesh, read_commands(sys.stdin.buffer))
    return 0


if __name__ == "__main__":
    sys.exit(main())
