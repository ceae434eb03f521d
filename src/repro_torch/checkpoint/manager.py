"""Checkpointing: atomic, async, optionally TAC-compressed (lossy).

The files are the reference's (``repro.checkpoint.manager``): each package
restores the other's ``step_XXXXXXXX.{npz,json}``, and for the same tree
(lossless, or lossy with the same byte codec in both) the two write the
same bytes.

  * **Logical storage** — checkpoints hold full tensors keyed by tree
    path (``"params/a/b"`` under the npz key ``params__a__b``), params
    before optimizer state, paths sorted.
  * **Atomicity** — write to ``step_XXXX.tmp`` then ``os.replace``; a
    manifest with CRCs makes truncated writes detectable.
  * **Async** — :meth:`CheckpointManager.save` copies every leaf to host
    memory before it returns (the port's train steps then overwrite the
    parameters in place), and a writer thread serializes the copies;
    ``wait()`` joins it.
  * **Sharded state** — a tree that holds a DTensor (the state of a
    data-parallel mesh, :mod:`repro_torch.launch.train`) is saved by
    every rank at once: each leaf is made whole in path order (an
    ``all_gather_into_tensor`` of a sharded leaf over the process group,
    :func:`repro_torch.optim.tree.whole`; a replicated leaf's local
    tensor), global rank 0 copies it to the host and the other ranks drop
    it, so a rank holds at most one whole leaf more on its device.  Rank
    0 alone writes (and encodes lossy leaves); the file is the logical
    file a one-process save of the whole tree writes, byte for byte.
    ``wait()`` (and a blocking save) then holds every rank at a barrier
    until the file is complete.
  * **Lossy mode** — parameter leaves of rank ≥ 2 and more than 4096
    values are stored as TACZ tensor blobs (:mod:`repro_torch.io.tensor`)
    at ``eb = eb_rel · max |a|`` of their float32 copy: their Lorenzo codes
    run on the card (kernel 5 for rank 3, kernel 1 and an axis-0
    difference for rank 4), and their restore on kernels 6 and 2.  The
    other leaves stay lossless.  Pre-TACZ manifests (no ``"format"``
    field) still restore.

bfloat16 (and float8) leaves are stored as same-width unsigned views and
named by numpy's dtype names (``"bfloat16"``), with the CRC over those
bytes.  Tensors restore onto ``device``; 0-dim integer leaves (the
optimizers' step counter) stay on the host, where the port keeps them.

**Elastic restore** — ``restore(step, mesh=, shardings=)`` reads the
logical file on every rank and makes each parameter leaf that
``shardings`` places a DTensor on ``mesh`` from the rank's own slice
(``DTensor.from_local``: no collective), whatever mesh wrote it;
optimizer leaves stay whole on ``device``.
"""
from __future__ import annotations

import json
import os
import threading
import zlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..core import compat
from ..core.sz import lorenzo_nd_recon
from ..device import resolve_device
from ..io import tensor as tacz_tensor
from ..optim.tree import whole

__all__ = ["CheckpointManager"]


def _codec_decompress(blob: bytes, codec: str) -> bytes:
    """Legacy (pre-TACZ) lossy-blob codec — restore path only."""
    if codec == "zstd":
        return compat.zstd_decompress(blob)
    return zlib.decompress(blob)


# numpy's savez cannot round-trip bfloat16 etc. — store them as
# same-width unsigned views and restore through the recorded dtype string.
_VIEW_AS = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8,
            "float8_e5m2": np.uint8}
#: the integer dtype of each view's width that both numpy and torch hold
_SHARED_VIEW = {np.uint16: (np.int16, torch.int16),
                np.uint8: (np.uint8, torch.uint8)}


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``torch.bfloat16`` → ``"bfloat16"``)."""
    return str(dtype).removeprefix("torch.")


def _to_storable(t: torch.Tensor) -> np.ndarray:
    """A host tensor as the numpy array the npz holds."""
    name = _dtype_name(t.dtype)
    if name in _VIEW_AS:
        view = _VIEW_AS[name]
        return t.view(_SHARED_VIEW[view][1]).numpy().view(view)
    return t.numpy()


def _from_storable(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _VIEW_AS:
        view = _VIEW_AS[dtype_name]
        return torch.from_numpy(a.view(_SHARED_VIEW[view][0])).view(
            getattr(torch, dtype_name))
    a = a.astype(np.dtype(dtype_name)) if a.dtype.name != dtype_name else a
    # (np.ascontiguousarray would turn a 0-dim array into a 1-dim one)
    return torch.from_numpy(a if a.flags.c_contiguous else a.copy())


def _flatten_with_paths(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            out.update(_flatten_with_paths(tree[k], f"{prefix}/{k}"))
        return out
    out[prefix] = tree
    return out


def _unflatten_from_paths(flat):
    root: dict = {}
    for path, v in flat.items():
        parts = [p for p in path.split("/") if p]
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A C-contiguous copy of a leaf in host memory that shares no storage
    with it (for a CPU tensor ``.cpu()`` would return the same storage)."""
    return t.detach().to("cpu", memory_format=torch.contiguous_format,
                         copy=True)


def _meshed(leaves) -> bool:
    """Whether any leaf is a DTensor (the save is then a collective).

    :raises ValueError: for a DTensor whose mesh does not hold every rank
        of the process group in rank order.
    """
    from torch.distributed.tensor import DTensor

    meshed = False
    for t in leaves:
        if isinstance(t, DTensor):
            meshed = True
            ranks = t.device_mesh.mesh.flatten().tolist()
            if ranks != list(range(dist.get_world_size())):
                raise ValueError(f"a leaf's mesh holds ranks {ranks}, not "
                                 f"every rank in rank order")
    return meshed


def _lossy_encode(a: torch.Tensor, eb_rel: float, device: torch.device):
    """Error-bounded "sz-light" encoding of a float32 host tensor into a
    TACZ tensor blob, the codes computed on ``device``."""
    d = a.to(device)
    rng = float(d.abs().max())
    if rng == 0 or eb_rel <= 0:
        return None
    eb = eb_rel * rng
    return {"blob": tacz_tensor.encode_tensor(d, eb, device=device), "eb": eb}


def _lossy_decode_legacy(entry, device: torch.device) -> torch.Tensor:
    """Decode pre-TACZ lossy entries (manifests without a "format" field)
    to float32 on ``device``."""
    raw = _codec_decompress(entry["blob"], entry.get("codec", "zstd"))
    codes = np.frombuffer(raw, dtype=entry["dtype"]).astype(np.int64)
    codes = torch.from_numpy(codes.reshape(entry["shape"])).to(device)
    q = lorenzo_nd_recon(codes)
    return (q.double() * 2 * entry["eb"]).float()


@dataclass
class CheckpointManager:
    """Atomic, asynchronous checkpoints in ``directory``, the newest
    ``keep`` kept; ``lossy_eb_rel > 0`` stores large parameter leaves
    lossy; tensors restore onto ``device`` (default ``"cuda"``)."""

    directory: str
    keep: int = 3
    lossy_eb_rel: float = 0.0        # 0 → lossless; e.g. 1e-4 → lossy params
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        os.makedirs(self.directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._barrier = False           # a save of sharded state is open

    # ------------------------------- save ---------------------------------

    def save(self, step: int, params, opt_state, extra=None, *,
             blocking: bool = False):
        """Copy every leaf to host memory now, write asynchronously (or
        before returning, with ``blocking``).

        A tree that holds a DTensor makes this a collective: every rank
        calls it at the same step with its own shards; rank 0 writes.

        :raises ValueError: for a DTensor whose mesh does not hold every
            rank of the process group in rank order.
        """
        flat = {**_flatten_with_paths(params, "params"),
                **_flatten_with_paths(opt_state, "opt")}
        meshed = _meshed(flat.values())
        writer = not meshed or dist.get_rank() == 0
        host = {"params": {}, "opt": {}, "extra": extra or {}}
        for path in list(flat):
            # one whole leaf at a time, in the same order on every rank
            a = flat.pop(path)
            if meshed:
                a = whole(a, dist.group.WORLD)
            if writer:
                host[path.split("/", 1)[0]][path] = _host_copy(a)
            del a
        self.wait()
        if blocking:
            if writer:
                self._write(step, host)
            if meshed:
                dist.barrier()
        else:
            if writer:
                self._thread = threading.Thread(
                    target=self._write, args=(step, host), daemon=True)
                self._thread.start()
            self._barrier = meshed

    def _write(self, step: int, host):
        arrays, manifest = {}, {"step": step, "entries": {}, "lossy": {}}
        for path, t in {**host["params"], **host["opt"]}.items():
            key = path.replace("/", "__")
            lossy = None
            if (self.lossy_eb_rel > 0 and path.startswith("params")
                    and t.dim() >= 2 and t.numel() > 4096):
                lossy = _lossy_encode(t.float(), self.lossy_eb_rel,
                                      self.device)
            if lossy is not None:
                arrays[key] = np.frombuffer(lossy["blob"], dtype=np.uint8)
                manifest["lossy"][key] = {
                    "format": "tacz", "eb": lossy["eb"],
                    "out_dtype": _dtype_name(t.dtype)}
            else:
                arrays[key] = _to_storable(t)
            manifest["entries"][key] = {
                "path": path, "shape": list(t.shape),
                "dtype": _dtype_name(t.dtype),
                "crc": zlib.crc32(arrays[key].tobytes()),
            }
        manifest["extra"] = host["extra"]
        base = os.path.join(self.directory, f"step_{step:08d}")
        tmp_npz, tmp_json = base + ".npz.tmp", base + ".json.tmp"
        with open(tmp_npz, "wb") as f:
            np.savez(f, **arrays)
        with open(tmp_json, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp_npz, base + ".npz")
        os.replace(tmp_json, base + ".json")
        self._gc()

    def _gc(self):
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            for ext in (".npz", ".json"):
                try:
                    os.remove(os.path.join(
                        self.directory, f"step_{s:08d}{ext}"))
                except OSError:
                    pass

    def wait(self):
        """Join the writer; after a save of sharded state, then meet the
        other ranks at a barrier (the file is complete for all)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()

    # ------------------------------ restore --------------------------------

    def list_steps(self):
        steps = []
        for f in os.listdir(self.directory):
            if f.startswith("step_") and f.endswith(".json"):
                steps.append(int(f[5:-5]))
        return sorted(steps)

    def _place(self, t: torch.Tensor) -> torch.Tensor:
        if t.dim() == 0 and not t.is_floating_point():
            return t                  # the step counter stays on the host
        return t.to(self.device)

    def _sharded(self, path: str, t: torch.Tensor, mesh, shardings: dict):
        """Leaf ``path`` as a DTensor on ``mesh`` built from this rank's
        slice (copied onto ``device``), if ``shardings`` places it; else
        placed whole."""
        pls = shardings.get(path)
        if pls is None:
            return self._place(t)
        from torch.distributed.tensor import DTensor

        from ..launch.sharding import local_slice

        local = local_slice(t, mesh, pls, mesh.get_coordinate()).to(
            self.device, memory_format=torch.contiguous_format, copy=True)
        return DTensor.from_local(local, mesh, pls, run_check=False,
                                  shape=t.shape, stride=t.stride())

    def restore(self, step: int, *, mesh=None, shardings=None):
        """Load a checkpoint: ``(params, opt_state, step)``, the tensors on
        ``device``.  Given a ``mesh`` (a ``DeviceMesh`` of ``device``'s
        type) and ``shardings`` (a tree of placements over the parameters,
        as :func:`repro_torch.launch.sharding.param_shardings` makes), each
        placed parameter leaf is a DTensor holding this rank's slice."""
        if mesh is not None and shardings is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh for a manager "
                                 f"on {self.device}")
            placed = _flatten_with_paths(shardings, "params")
        else:
            placed = None
        base = os.path.join(self.directory, f"step_{step:08d}")
        with open(base + ".json") as f:
            manifest = json.load(f)
        with np.load(base + ".npz") as z:
            flat = {}
            for key, meta in manifest["entries"].items():
                a = z[key]
                if zlib.crc32(np.ascontiguousarray(a).tobytes()) != meta["crc"]:
                    raise IOError(f"checkpoint corruption at {meta['path']}")
                if key in manifest["lossy"]:
                    li = manifest["lossy"][key]
                    if li.get("format") == "tacz":
                        t = tacz_tensor.decode_tensor(a.tobytes(),
                                                      device=self.device)
                    else:
                        t = _lossy_decode_legacy(
                            {"blob": a.tobytes(), "eb": li["eb"],
                             "dtype": li["codes_dtype"],
                             "shape": tuple(li["shape"]),
                             "codec": li.get("codec", "zstd")},
                            self.device)
                    t = t.to(getattr(torch, li["out_dtype"]))
                else:
                    t = _from_storable(a, meta["dtype"])
                flat[meta["path"]] = (
                    self._place(t) if placed is None
                    else self._sharded(meta["path"], t, mesh, placed))
        tree = _unflatten_from_paths(flat)
        return tree["params"], tree["opt"], int(manifest["step"])

    def restore_latest(self, *, mesh=None, shardings=None):
        steps = self.list_steps()
        if not steps:
            return None
        return self.restore(steps[-1], mesh=mesh, shardings=shardings)
