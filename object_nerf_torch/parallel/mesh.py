"""Data parallelism over a `torch.distributed` process group.

Counterpart of `object_nerf_tpu/parallel/mesh.py` (a 1-D `data` mesh over
every device). One process per GPU, started by `torchrun`: the parameters are
replicated, each process takes its rows of the global ray batch, and the
weight gradients are all-reduced (SUM) in one flat buffer between
`loss.backward()` and `optimizer.step()`, the counterpart of the psum in the
JAX package's backward launcher (`ops/pallas_mlp_vjp.py:437-454`). The loss
divides each term by its global mask count (`all_reduce_sum` of the counts),
so a step is the JAX package's global-batch step: one loss over all rays,
not a mean of per-process means. Renders give each rank the chunks
`r, r + W, r + 2W, ...` of a frame and put the frame back in order on every
rank with one `all_gather` (`gather_maps`).

Without a process group every helper is that of one process (rank 0 of 1)
and the callers keep their single-process path.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def is_distributed() -> bool:
    """Whether this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def initialize_distributed(coordinator: Optional[str] = None, backend: Optional[str] = None,
                           device: str = "cuda") -> int:
    """Join the process group and return its size.

    The rank and the world size come from the environment (`RANK`,
    `WORLD_SIZE`, as `torchrun` sets them); the rendezvous is `coordinator`
    (`host:port`, or a `tcp://` or `file://` URL), else `MASTER_ADDR` /
    `MASTER_PORT`. `backend` defaults to NCCL for `device` cuda and gloo for
    cpu. On cuda the current device becomes `LOCAL_RANK` modulo the number
    of cards (ranks share a card only over gloo). Raises when no group can
    start: the caller never carries on as one process. Safe to call when the
    group already exists."""
    if is_distributed():
        return world_size()
    missing = [k for k in ("RANK", "WORLD_SIZE") if k not in os.environ]
    if coordinator is None:
        missing += [k for k in ("MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"distributed training asked for, but {', '.join(missing)} not set: start the "
            f"processes with torchrun (e.g. torchrun --nproc_per_node=N -m "
            f"object_nerf_torch.train ... tpu.distributed=true)")
    device_type = torch.device(device).type
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda requested but CUDA is not available")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    init_method = "env://"
    if coordinator is not None:
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init_method,
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return world_size()


def initialize_from_config(config) -> int:
    """Join the process group when `config.tpu.distributed` is set (the
    JAX CLIs' key; `tpu.coordinator` and `device` as `initialize_distributed`
    takes them) and say so; returns the world size, 1 without a group."""
    tpu = config.get("tpu") or {}
    if not tpu.get("distributed", False):
        return world_size()
    n = initialize_distributed(tpu.get("coordinator"), device=config.get("device", "cuda"))
    print(f"distributed: rank {rank()} of {n}, backend {dist.get_backend()}")
    return n


def destroy() -> None:
    if is_distributed():
        dist.destroy_process_group()


def barrier() -> None:
    """Wait for every rank (no-op without a group)."""
    if not is_distributed():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_rows(n: int) -> slice:
    """This rank's rows `[r n / W, (r + 1) n / W)` of a global batch of `n`
    rows. Raises when the world size does not divide `n`: the batch is not
    padded (the JAX package leaves padding to the caller too)."""
    w, r = world_size(), rank()
    if n % w:
        raise ValueError(f"a global batch of {n} rays does not split over {w} processes: "
                         f"choose train.batch_size as a multiple of {w}")
    m = n // w
    return slice(r * m, (r + 1) * m)


def shard_batch(batch: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """This rank's rows of every array of a global (host) batch."""
    n = {len(v) for v in batch.values()}
    if len(n) != 1:
        raise ValueError(f"batch arrays of different lengths: {sorted(n)}")
    sl = shard_rows(n.pop())
    return {k: v[sl] for k, v in batch.items()}


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """A detached copy of `t` summed over the ranks (no gradient flows
    through it): the global mask counts of the loss, the global metrics."""
    out = t.detach().clone()
    if is_distributed():
        dist.all_reduce(out)
    return out


def all_reduce_grads(params: Iterable[torch.Tensor]) -> int:
    """Sum every parameter's gradient over the ranks: one flat buffer, one
    all-reduce. A parameter without a gradient adds zeros and keeps none.
    Returns the bytes reduced."""
    params = list(params)
    dtypes = {p.dtype for p in params}
    if len(dtypes) != 1:
        raise ValueError(f"parameters of several dtypes: {sorted(map(str, dtypes))}")
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    if is_distributed():
        dist.all_reduce(flat)
    offset = 0
    for p in params:
        n = p.numel()
        if p.grad is not None:
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n
    return flat.numel() * flat.element_size()


def broadcast_tensors(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Overwrite every rank's tensors with rank `src`'s, in place."""
    if not is_distributed():
        return
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("broadcast_tensors needs contiguous tensors")
        view = t.view(torch.uint8) if t.dtype == torch.bool else t
        dist.broadcast(view.view(-1), src)


def rank_chunks(n_chunks: int) -> List[int]:
    """The chunks this rank renders: `r, r + W, r + 2W, ...`."""
    return list(range(rank(), n_chunks, world_size()))


def render_chunks(n: int, chunk: int,
                  render: Callable[[int], Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The maps of `n` rows rendered `chunk` rows at a time: `render(c)`
    returns chunk `c`'s maps. Under a group each rank renders its chunks
    (`rank_chunks`) and every rank gets the whole frame (`gather_maps`)."""
    n_chunks = -(-n // chunk)
    mine = rank_chunks(n_chunks)
    outs = [render(c) for c in mine or [0]]  # a rank without a chunk renders one for the layout
    maps = {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}
    if not is_distributed():
        return maps
    if not mine:
        maps = {k: v[:0] for k, v in maps.items()}
    return gather_maps(maps, [min(chunk, n - c * chunk) for c in range(n_chunks)])


def gather_maps(local: Mapping[str, torch.Tensor], chunk_rows: Sequence[int]
                ) -> Dict[str, torch.Tensor]:
    """A frame's maps in chunk order on every rank. `local` holds this
    rank's chunks (`rank_chunks`) one after another, each map with its rows
    first; `chunk_rows` gives the rows of every chunk of the frame. One
    all-gather of the maps side by side, padded to the largest rank's rows."""
    if not is_distributed():
        return dict(local)
    keys = sorted(local)
    dtypes = {local[k].dtype for k in keys}
    if len(dtypes) != 1:
        raise ValueError(f"maps of several dtypes: {sorted(map(str, dtypes))}")
    rows = local[keys[0]].shape[0]
    cols = [int(np.prod(local[k].shape[1:])) for k in keys]
    flat = torch.cat([local[k].reshape(rows, c) for k, c in zip(keys, cols)], 1)
    w = world_size()
    per_rank = [sum(chunk_rows[c] for c in range(q, len(chunk_rows), w)) for q in range(w)]
    if rows != per_rank[rank()]:
        raise ValueError(f"rank {rank()} holds {rows} rows, its chunks {per_rank[rank()]}")
    padded = flat.new_zeros(max(per_rank), flat.shape[1])
    padded[:rows] = flat
    bufs = [torch.empty_like(padded) for _ in range(w)]
    dist.all_gather(bufs, padded)
    pieces, offsets = [], [0] * w
    for c, n in enumerate(chunk_rows):
        q = c % w
        pieces.append(bufs[q][offsets[q]:offsets[q] + n])
        offsets[q] += n
    frame = torch.cat(pieces)
    out, col = {}, 0
    for k, n in zip(keys, cols):
        out[k] = frame[:, col:col + n].reshape((frame.shape[0],) + local[k].shape[1:])
        col += n
    return out
