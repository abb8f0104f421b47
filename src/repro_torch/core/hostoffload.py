"""Host memory for the training step: the device-to-host and host-to-device
leg of ``carry_offload="host"`` and ``offload_opt=True`` (the port of
``repro/core/hostoffload.py``).

MiCS §3.1 sizes the partition group from what must stay in HBM.  Two of
the largest residents are storage between two uses: the prefetch carry's
gathered buffers (written in the forward, read once in the backward) and
AdamW's m and v (read and written once a boundary).  Both can live in host
memory and cross to the card around their one use.

The reference keeps them in a process-global dict that ordered
``io_callback``s fill.  Here a :class:`HostStash` owns, for one run:

* **pinned host slots** for the carry, one a (pool, layer), allocated at
  their first use and reused from micro-step to micro-step and from step
  to step (:meth:`HostStash.put` / :meth:`HostStash.get`);
* **one copy stream** a card.  Every copy runs on it, ordered against the
  compute stream by CUDA events; a device buffer whose copy may still be in
  flight is kept alive with ``record_stream``;
* counters: bytes down (device to host), bytes up, and the carry slots
  still held.

The optimizer moments are not slots: with ``offload_opt`` the state dict
holds them as pinned host tensors (:func:`pinned_zeros`), and the boundary
streams a slice at a time through :meth:`HostStash.fetch` and
:meth:`HostStash.write_back`.

Pinned memory is page-locked in place (``cudaHostRegister`` on a host
buffer of exactly the tensor's bytes, released with the buffer), not taken
from PyTorch's caching host allocator, which rounds every block up to a
power of two (26.5 GB of recurrentgemma-2b moments would lock ~36.5 GB).
If the memory cannot be locked the call raises; nothing falls back to
pageable memory.  On the CPU (the tests) a slot is an ordinary host tensor
and every copy a plain one.
"""

from __future__ import annotations

import math
import mmap
import threading
import weakref

import numpy as np
import torch

_PINNED_LOCK = threading.Lock()
_PINNED = {"bytes": 0, "peak": 0}   # page-locked by pinned_zeros: held now, the most held


def _unregister(ptr: int, nbytes: int) -> None:
    torch.cuda.cudart().cudaHostUnregister(ptr)
    with _PINNED_LOCK:
        _PINNED["bytes"] -= nbytes


def pinned_zeros(shape, dtype: torch.dtype, device: str | torch.device) -> torch.Tensor:
    """A zero host tensor for the data of a run on ``device``: page-locked
    in place for a card (exactly its bytes of an anonymous mapping advised
    into huge pages, which have far fewer pages to lock than 4 KB ones;
    unlocked when the last tensor on it is freed), ordinary host memory for
    the CPU.  Raises ``RuntimeError`` if the memory cannot be locked."""
    if torch.device(device).type != "cuda":
        return torch.zeros(shape, dtype=dtype)
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    area = mmap.mmap(-1, max(nbytes, 1))       # anonymous: reads as zeros
    try:
        area.madvise(mmap.MADV_HUGEPAGE)
    except OSError:
        pass   # a kernel without huge pages locks 4 KB pages, only slower
    buf = np.frombuffer(area, np.uint8)
    if nbytes:
        ptr = buf.ctypes.data
        cudart = torch.cuda.cudart()
        err = cudart.cudaHostRegister(ptr, nbytes, 0)
        if err != cudart.cudaError.success:
            raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed ({err}): "
                               "host memory cannot be pinned for the offload")
        with _PINNED_LOCK:
            _PINNED["bytes"] += nbytes
            _PINNED["peak"] = max(_PINNED["peak"], _PINNED["bytes"])
        # numpy clears an array's weak references before it lets go of the
        # mapping, so the memory is unlocked while it is still mapped.
        weakref.finalize(buf, _unregister, ptr, nbytes)
    return torch.from_numpy(buf)[:nbytes].view(dtype).view(shape)


def pinned_bytes() -> int:
    """Bytes that :func:`pinned_zeros` holds page-locked in this process."""
    with _PINNED_LOCK:
        return _PINNED["bytes"]


def pinned_peak() -> int:
    """The most bytes :func:`pinned_zeros` has held page-locked at once in
    this process since :func:`reset_pinned_peak` (or the start)."""
    with _PINNED_LOCK:
        return _PINNED["peak"]


def reset_pinned_peak() -> None:
    """Start :func:`pinned_peak`'s window at the bytes held now."""
    with _PINNED_LOCK:
        _PINNED["peak"] = _PINNED["bytes"]


def is_host_resident(t: torch.Tensor, device: torch.device) -> bool:
    """``t`` lies in host memory as a run on ``device`` needs it: pinned
    for a card, any host tensor for the CPU."""
    return t.device.type == "cpu" and (device.type != "cuda" or t.is_pinned())


class Carry:
    """The handle that a saved tensor's pack hook keeps for a buffer moved
    into a carry slot.  The slot counts as held while its handle is alive
    and not yet fetched: when autograd frees a graph without running its
    backward, the slot frees with it."""

    __slots__ = ("key", "device", "__weakref__")

    def __init__(self, key, device: torch.device):
        self.key, self.device = key, device


class HostStash:
    """The pinned carry slots, the copy stream and the byte counters of one
    run (one ``CommEngine``'s, :attr:`CommEngine.host_stash`)."""

    def __init__(self):
        self._slots: dict = {}     # key -> host tensor
        self._held: dict = {}      # key -> weakref of its Carry handle
        self._streams: dict = {}   # card -> copy stream
        self.bytes_down = 0
        self.bytes_up = 0

    # -- counters ----------------------------------------------------------
    def live_slots(self) -> int:
        """Carry slots holding a buffer that no backward has fetched yet."""
        return sum(ref() is not None for ref in self._held.values())

    def slot_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._slots.values())

    def snapshot(self) -> dict:
        return {"bytes_down": self.bytes_down, "bytes_up": self.bytes_up,
                "live_slots": self.live_slots(), "slots": len(self._slots),
                "slot_bytes": self.slot_bytes()}

    # -- the copies ----------------------------------------------------------
    def _copy_stream(self, device: torch.device):
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device)
        return stream

    def join(self, device: torch.device) -> None:
        """Make ``device``'s current stream wait for every copy issued so
        far, so that work after it (and a synchronise) sees them done."""
        if device.type == "cuda" and device in self._streams:
            torch.cuda.current_stream(device).wait_stream(self._streams[device])

    def fetch(self, host: torch.Tensor, device: torch.device):
        """``host`` (a slot, or a slice of a host tensor) copied to
        ``device`` on the copy stream: ``(tensor, event)``; the compute
        stream must :meth:`ready` the event before use.  The buffer comes
        from the copy stream's pool and is marked as used by the compute
        stream, so the copy waits for no compute."""
        self.bytes_up += host.numel() * host.element_size()
        if device.type != "cuda":
            return host.clone(), None
        copy = self._copy_stream(device)
        with torch.cuda.stream(copy):
            out = torch.empty(host.shape, dtype=host.dtype, device=device)
            out.copy_(host, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy)
        out.record_stream(torch.cuda.current_stream(device))
        return out, done

    def ready(self, event, device: torch.device) -> None:
        """The compute stream waits for a copy of :meth:`fetch`."""
        if event is not None:
            torch.cuda.current_stream(device).wait_event(event)

    def write_back(self, host: torch.Tensor, x: torch.Tensor) -> None:
        """Copy ``x`` into ``host`` on the copy stream, after the compute
        stream's work so far; ``x`` stays alive until the copy is done."""
        self.bytes_down += x.numel() * x.element_size()
        if not x.is_cuda:
            host.copy_(x)
            return
        cur = torch.cuda.current_stream(x.device)
        copy = self._copy_stream(x.device)
        copy.wait_stream(cur)
        with torch.cuda.stream(copy):
            host.copy_(x, non_blocking=True)
        x.record_stream(copy)

    # -- the carry ---------------------------------------------------------
    def put(self, key, x: torch.Tensor) -> Carry:
        """Move ``x`` into the slot ``key`` (allocated on first use, then
        reused); returns its handle.  Raises if the slot still holds a
        buffer or ``x`` does not fit it."""
        slot = self._slots.get(key)
        if slot is None:
            slot = self._slots[key] = pinned_zeros(x.shape, x.dtype, x.device)
        if slot.shape != x.shape or slot.dtype != x.dtype:
            raise ValueError(f"carry slot {key}: {slot.dtype} {tuple(slot.shape)}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        held = self._held.get(key)
        if held is not None and held() is not None:
            raise RuntimeError(f"carry slot {key} still holds a buffer no backward fetched")
        self.write_back(slot, x)
        handle = Carry(key, x.device)
        self._held[key] = weakref.ref(handle)
        return handle

    def get(self, handle: Carry) -> torch.Tensor:
        """The buffer of ``handle`` back on its device, ready for the compute
        stream; the slot is free again."""
        held = self._held.pop(handle.key, None)
        if held is None or held() is not handle:
            raise RuntimeError(f"carry slot {handle.key} was fetched already")
        out, done = self.fetch(self._slots[handle.key], handle.device)
        self.ready(done, handle.device)
        return out
