import os
import threading

# One getrandom() syscall buys 256 ids: the per-call syscall (which
# also releases the GIL, stalling the scheduler hot loop under
# contention) showed up as a top sample in control-plane profiles.
_BATCH_IDS = 256
_local = threading.local()


def _reset_after_fork() -> None:
    # A forked child inherits the surviving thread's hexbuf/pos and
    # would replay up to 255 of the parent's upcoming ids — colliding
    # eval/alloc ids across processes. Force a fresh urandom draw.
    _local.pos = 0


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reset_after_fork)


def generate_uuid() -> str:
    """Random identifier for jobs-internal objects (allocs, evals, nodes).

    Same shape as the reference's structs.GenerateUUID
    (reference nomad/structs/structs.go uses crypto/rand hex-8-4-4-4-12).
    Entropy is drawn in thread-local batches; each id is an independent
    16-byte slice, so ids stay crypto-random and collision-free across
    threads and processes.
    """
    pos = getattr(_local, "pos", 0)
    if pos == 0:
        _local.hexbuf = os.urandom(16 * _BATCH_IDS).hex()
    h = _local.hexbuf
    off = pos * 32
    _local.pos = (pos + 1) % _BATCH_IDS
    return (
        f"{h[off:off + 8]}-{h[off + 8:off + 12]}-{h[off + 12:off + 16]}"
        f"-{h[off + 16:off + 20]}-{h[off + 20:off + 32]}"
    )
