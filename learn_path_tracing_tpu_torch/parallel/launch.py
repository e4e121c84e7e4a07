"""Start a ``torch.distributed`` job of ``nproc`` ranks on this host.

    launch(nproc, fn, *args, device="cuda")

spawns ``nproc`` processes (``torch.multiprocessing.spawn``); each joins
the process group and calls ``fn(*args)``, and rank 0's return value comes
back to the caller. ``fn`` must be a module-level function, since spawn
pickles it by name.

- ``device='cuda'``: NCCL, one rank a card. Each rank calls
  ``torch.cuda.set_device(rank)`` before ``init_process_group('nccl',
  init_method='tcp://127.0.0.1:<free port>')``. NCCL refuses two ranks on
  one card, so ``nproc`` may not exceed ``torch.cuda.device_count()``, and
  there is no card-less fallback.
- ``device='cpu'``: gloo, rendezvous through a ``FileStore`` in a temporary
  directory (no TCP port to race for).

``init_group`` joins one process to a group; a single process may call it
with ``world_size=1`` to drive the sharded functions in-process.
"""

from __future__ import annotations

import os
import socket
import tempfile

import torch
import torch.distributed as dist


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_device(nproc: int, device) -> None:
    """Raise unless ``nproc`` ranks can run on ``device``: on CUDA, one rank
    a card."""
    if nproc < 1:
        raise ValueError(f"nproc={nproc} must be >= 1")
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r}: no CUDA device is available; pass "
                               "--device cpu to run the ranks on the CPU")
        if nproc > torch.cuda.device_count():
            raise ValueError(f"nproc={nproc} > {torch.cuda.device_count()} CUDA devices: "
                             "NCCL takes one rank a card")


def init_group(rank: int, world_size: int, device, *, port: int | None = None,
               store_dir: str | None = None) -> None:
    """Join the process group as ``rank`` of ``world_size``: NCCL over
    ``tcp://127.0.0.1:<port>`` on the card (after selecting card ``rank``),
    gloo through a ``FileStore`` in ``store_dir`` on the CPU."""
    if backend_for(device) == "nccl":
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world_size, rank=rank)
    else:
        store = dist.FileStore(os.path.join(store_dir, "store"), world_size)
        dist.init_process_group("gloo", store=store, world_size=world_size, rank=rank)


def to_host(value):
    """``value`` with every tensor in it copied to the CPU (for rank 0's
    result file)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, dict):
        return {k: to_host(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(to_host(v) for v in value)
    return value


def _rank_main(rank, nproc, device, workdir, port):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // nproc))
    init_group(rank, nproc, device, port=port, store_dir=workdir)
    try:
        fn, args = torch.load(os.path.join(workdir, "job.pt"), weights_only=False)
        result = fn(*args)
        dist.barrier()
        if rank == 0:
            torch.save(to_host(result), os.path.join(workdir, "result.pt"))
    finally:
        dist.destroy_process_group()


def launch(nproc: int, fn, *args, device="cuda"):
    """Run ``fn(*args)`` on ``nproc`` ranks of a new process group and
    return rank 0's result (its tensors on the CPU). A failure on any rank
    raises here."""
    import torch.multiprocessing as mp

    check_device(nproc, device)
    with tempfile.TemporaryDirectory() as workdir:
        torch.save((fn, args), os.path.join(workdir, "job.pt"))
        port = free_port() if backend_for(device) == "nccl" else None
        mp.spawn(_rank_main, args=(nproc, str(device), workdir, port),
                 nprocs=nproc, join=True)
        return torch.load(os.path.join(workdir, "result.pt"), weights_only=False)


def run_calls(calls) -> list:
    """A job for ``launch``: each ``(fn, args, kwargs, mesh_shape)`` of
    ``calls`` in turn on this rank, as ``fn(*args, mesh=<mesh>, **kwargs)``
    over ``make_mesh(*mesh_shape)`` (one mesh a shape), or ``fn(*args,
    **kwargs)`` when ``mesh_shape`` is None. Returns a result a call:
    ``("ok", value)``, or ``("ValueError", message)`` where the call raised
    it. A ``ValueError`` must come on every rank before any collective, as
    the argument checks of ``parallel.mesh`` raise it; other exceptions end
    the job."""
    from .mesh import make_mesh

    meshes, out = {}, []
    for fn, args, kwargs, shape in calls:
        try:
            if shape is None:
                out.append(("ok", fn(*args, **kwargs)))
                continue
            if shape not in meshes:
                meshes[shape] = make_mesh(*shape)
            out.append(("ok", fn(*args, mesh=meshes[shape], **kwargs)))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out
