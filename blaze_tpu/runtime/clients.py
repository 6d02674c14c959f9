"""Primitive clients: MSM, NTT, Poseidon — the ingo_* module analogs.

API shape follows the reference's clients 1:1 (init struct -> lifecycle
methods -> wire-format results), with JAX async dispatch supplying the
queue/poll machinery the FPGA exposes as registers.

Both lifecycle orders work.  set_data -> start_process stages the full
operand set, then dispatches (one compiled launch).  The reference's own
order — initialize -> start_process -> set_data (the FPGA consumes the DMA
stream after the task is queued, msm_api.rs:113-220) — opens a STREAMING
task: each set_data chunk is transferred and its per-window partials
dispatched immediately, so the host->device copy of chunk k+1 overlaps
compute of chunk k and the full operand set is never resident at once.

MSM     <- /root/reference/src/ingo_msm/msm_api.rs
NTT     <- /root/reference/src/ingo_ntt/ntt_api.rs
Poseidon<- /root/reference/src/ingo_hash/poseidon_api.rs
"""
from __future__ import annotations

import collections
import dataclasses
import logging
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..curves import (
    CURVE_ALIASES,
    CURVES,
    Curve,
    decode_affine_points,
    decode_scalars,
    encode_projective_result,
)
from ..fields.codec import bytes_to_limbs, limbs_to_bytes
from ..fields.spec import FieldSpec
from ..hash.params import params_from_csv
from ..hash.tree import (
    LEAF_ARITY,
    MerkleTreeBuilder,
    TreeMode,
    base_layer_size,
)
from ..msm import MSM, MSMConfig, default_window_bits, split_scalars
from ..ntt import make_ntt
from .device import DeviceContext
from .primitive import DriverPrimitive, ImageParams, timed
from ..utils.errors import (
    DeviceError,
    InvalidPrimitiveParam,
    NotReady,
)
from ..utils.misc import elide_payload

log = logging.getLogger("blaze_tpu.clients")


def _device_put(x, device):
    """Host -> device transfer.  A failure (out of memory included)
    surfaces as the typed DeviceError (the WriteError analog,
    error.rs:7-10); it is not retried."""
    try:
        return jax.device_put(x, device)
    except Exception as e:
        raise DeviceError(f"device_put failed: {e}", buffer=str(device)) from e


def _resolve_curve(curve) -> Curve:
    if isinstance(curve, Curve):
        return curve
    if curve in CURVE_ALIASES:
        return Curve(CURVE_ALIASES[curve])
    return Curve(CURVES[curve])


# ============================================================== MSM client
@dataclasses.dataclass
class MSMInit:
    """msm_api.rs:16-22 analog."""

    curve: str = "bls12_381"
    mem_type: str = "dma"           # 'dma' | 'hbm' (PointMemoryType)
    precompute_factor: int = 1      # reference uses 1 or 8 (msm_api.rs:39-40)


@dataclasses.dataclass
class MSMParams:
    """msm_api.rs:25-30 analog."""

    nof_elements: int
    hbm_point_addr: Optional[str] = None  # cache key (HBM addr analog)


@dataclasses.dataclass
class MSMInput:
    """msm_api.rs:32-37 analog; three set_data modes (README.md:83-113)."""

    scalars: object                  # bytes or (N, Ls) uint32 limbs
    points: Optional[object] = None  # bytes or (N, 2, L) canonical limbs
    params: Optional[MSMParams] = None


@dataclasses.dataclass
class MSMResult:
    """msm_api.rs result analog: z||y||x LE bytes + task label."""

    result: bytes
    label: int


class MSMClient(DriverPrimitive):
    def __init__(self, init: MSMInit, ctx: Optional[DeviceContext] = None,
                 config: Optional[MSMConfig] = None):
        super().__init__()
        self.init = init
        self.ctx = ctx or DeviceContext()
        self.curve = _resolve_curve(init.curve)
        self.engine = MSM(self.curve, config)
        self._params: Optional[MSMParams] = None
        # Resident operands: (N, 2, L) affine Montgomery points and
        # (N, Ls) canonical scalar limbs, uint32.
        self._points = None
        self._scalars = None
        self._scalar_bits = None       # < fr.bits in precompute mode
        # In-flight result queue: (label, device array) FIFO — the
        # reference's multi-deep task queue (msm_hw_code.rs:19-25), where a
        # new start_process never clobbers an unpopped result.
        self._inflight: collections.deque = collections.deque()
        self._hbm_cache: dict = {}     # persistent point residency (mode 3)
        # Open streaming task (start_process before set_data — the
        # reference's lifecycle order, msm_api.rs:113-217): chunks are
        # consumed as they arrive, per-window partials accumulate on
        # device, the fold runs at wait_result.
        self._stream: Optional[dict] = None

    def loaded_binary_parameters(self) -> ImageParams:
        spec = self.curve.spec
        return ImageParams(
            "msm",
            {
                "curve": spec.name,
                "point_bytes": spec.point_bytes,
                "result_bytes": spec.result_bytes,
                "scalar_bytes": spec.scalar_bytes,
                "precompute_factor": self.init.precompute_factor,
                "window_bits": self.engine.config.window_bits,
                "mem_type": self.init.mem_type,
            },
        )

    def initialize(self, param: MSMParams) -> None:
        """Set task size / point source (msm_api.rs:72-111)."""
        self._params = param

    def set_data(self, input: MSMInput) -> None:
        """Three modes (msm_api.rs:122-220):
        1. points + scalars (DMA);
        2. points cached under a key + scalars (HBM load);
        3. scalars only, points reused from cache (HBM reuse).

        With an OPEN STREAMING TASK (start_process called first — the
        reference's order, §3.1: the engine consumes the DMA stream after
        the task is queued, msm_api.rs:156-217) each call stages one chunk
        and dispatches its per-window partials immediately: the transfer
        of chunk k+1 overlaps the compute of chunk k (JAX async dispatch),
        and the full operand set never has to be resident at once."""
        if self._stream is not None:
            return self._set_data_stream(input)
        with timed(self._timings, "set_data_s"):
            params = input.params or self._params
            if params is None:
                raise NotReady("initialize() first (no MSMParams)")
            self._params = params
            spec = self.curve.spec
            log.debug("set_data scalars=%s points=%s",
                      elide_payload(input.scalars), elide_payload(input.points))

            if isinstance(input.scalars, (bytes, bytearray, memoryview)):
                scal = decode_scalars(input.scalars, spec)
            else:
                scal = np.asarray(input.scalars, dtype=np.uint32)
            if scal.shape[0] != params.nof_elements:
                raise InvalidPrimitiveParam(
                    f"scalars {scal.shape[0]} != nof_elements {params.nof_elements}"
                )
            k = self.init.precompute_factor
            self._scalar_bits = None
            if k > 1:
                # Slice scalar bits per precomputed multiple up front
                # (msm_api.rs:39-40 windowing); the engine then sees a
                # plain (k*N)-point MSM with short scalars.
                scal, self._scalar_bits = split_scalars(
                    scal, k, spec.fr.bits
                )
                scal = np.asarray(scal)
            self._scalars = _device_put(scal, self.ctx.device)

            key = params.hbm_point_addr
            if input.points is not None:
                if isinstance(input.points, (bytes, bytearray, memoryview)):
                    pts = decode_affine_points(input.points, spec)
                else:
                    pts = np.asarray(input.points, dtype=np.uint32)
                if pts.shape[0] != k * params.nof_elements:
                    raise InvalidPrimitiveParam(
                        f"want {k * params.nof_elements} points "
                        f"(precompute_factor={k}), got {pts.shape[0]}"
                    )
                if k > 1:
                    # Wire order is point-major — each base followed by its
                    # k-1 multiples (tests/msm/mod.rs:360-380); the engine
                    # wants multiple-major slices (msm/precompute.py).
                    n = params.nof_elements
                    pts = (
                        pts.reshape(n, k, 2, -1)
                        .transpose(1, 0, 2, 3)
                        .reshape(k * n, 2, -1)
                    )
                dev = self._to_mont(_device_put(pts, self.ctx.device))
                if key is not None:
                    self._hbm_cache[key] = dev      # mode 2: load-to-HBM
                self._points = dev
            else:
                if key is None or key not in self._hbm_cache:
                    raise NotReady(
                        "scalars-only set_data needs points cached under "
                        f"hbm_point_addr (key={key!r})"
                    )
                self._points = self._hbm_cache[key]  # mode 3: reuse

    def _set_data_stream(self, input: MSMInput) -> None:
        """One streamed chunk: stage + dispatch partials (no sync)."""
        with timed(self._timings, "set_data_s"):
            st = self._stream
            params = self._params
            spec = self.curve.spec
            if isinstance(input.scalars, (bytes, bytearray, memoryview)):
                scal = decode_scalars(input.scalars, spec)
            else:
                scal = np.asarray(input.scalars, dtype=np.uint32)
            nchunk = scal.shape[0]
            if st["consumed"] + nchunk > params.nof_elements:
                raise InvalidPrimitiveParam(
                    f"stream overflow: {st['consumed']} + {nchunk} > "
                    f"{params.nof_elements}"
                )
            k = self.init.precompute_factor
            scalar_bits = None
            if k > 1:
                scal, scalar_bits = split_scalars(scal, k, spec.fr.bits)
                scal = np.asarray(scal)
            sdev = _device_put(scal, self.ctx.device)

            if input.points is not None:
                if isinstance(input.points, (bytes, bytearray, memoryview)):
                    pts = decode_affine_points(input.points, spec)
                else:
                    pts = np.asarray(input.points, dtype=np.uint32)
                if pts.shape[0] != k * nchunk:
                    raise InvalidPrimitiveParam(
                        f"want {k * nchunk} chunk points "
                        f"(precompute_factor={k}), got {pts.shape[0]}"
                    )
                if k > 1:
                    pts = (
                        pts.reshape(nchunk, k, 2, -1)
                        .transpose(1, 0, 2, 3)
                        .reshape(k * nchunk, 2, -1)
                    )
                pdev = self._to_mont(_device_put(pts, self.ctx.device))
            else:
                key = params.hbm_point_addr
                if key is None or key not in self._hbm_cache:
                    raise NotReady(
                        "streamed scalars-only chunks need points cached "
                        f"under hbm_point_addr (key={key!r})"
                    )
                cache = self._hbm_cache[key]
                lo, hi = st["consumed"], st["consumed"] + nchunk
                if k > 1:
                    # cache is multiple-major over the FULL base set:
                    # gather this chunk's rows for every multiple
                    nb = params.nof_elements
                    idx = jnp.asarray(np.concatenate(
                        [m * nb + np.arange(lo, hi) for m in range(k)]
                    ))
                    pdev = jnp.take(cache, idx, axis=0)
                else:
                    pdev = cache[lo:hi]

            part = self.engine.msm_partial(pdev, sdev, st["c"], scalar_bits)
            st["wsums"] = self.engine.accumulate(st["wsums"], part)
            st["consumed"] += nchunk

    def start_process(self, param=None) -> None:
        """Queue the task (PUSH_MSM_TASK analog, msm_api.rs:113-120).
        Returns immediately (JAX dispatch is async) and may be called
        repeatedly — each task joins the in-flight queue with its label.

        Called BEFORE set_data (with a task size from initialize()), it
        opens a streaming task — the reference's own order (§3.1:
        initialize -> start_process -> set_data; the engine consumes the
        DMA stream after the task is queued, msm_api.rs:113-217)."""
        if self._stream is not None:
            raise NotReady(
                f"streaming task open ({self._stream['consumed']} of "
                f"{self._params.nof_elements} elements fed)"
            )
        if self._points is None or self._scalars is None:
            if self._params is None:
                raise NotReady("set_data() first")
            with timed(self._timings, "start_s"):
                n = self._params.nof_elements
                c = min(self.engine.config.window_bits,
                        default_window_bits(n))
                self._stream = {
                    "label": self._push_task(),
                    "wsums": None,
                    "consumed": 0,
                    "c": c,
                }
            return
        with timed(self._timings, "start_s"):
            label = self._push_task()
            out = self.engine(
                self._points, self._scalars, scalar_bits=self._scalar_bits
            )
            self._inflight.append((label, out))

    def wait_result(self) -> None:
        """Block until the oldest queued task is done (RESULT_VALID poll
        analog, msm_api.rs:222-238).  An open streaming task is closed
        here: all declared elements must have been fed, the accumulated
        window partials are folded, and the fold is synced."""
        if self._stream is not None:
            st = self._stream
            n = self._params.nof_elements
            if st["consumed"] < n:
                raise NotReady(
                    f"streamed {st['consumed']} of {n} elements"
                )
            with timed(self._timings, "wait_s"):
                out = self.engine.finalize(st["wsums"], st["c"])
                self._inflight.append((st["label"], out))
                self._stream = None
                jax.block_until_ready(out)
            return
        if not self._inflight:
            return
        with timed(self._timings, "wait_s"):
            jax.block_until_ready(self._inflight[0][1])

    def result(self, param=None) -> Optional[MSMResult]:
        """Pop the oldest completed task (POP_RESULT, msm_api.rs:240-274)."""
        if self._stream is not None:
            self.wait_result()      # close the streaming task (fold + sync)
        if not self._inflight:
            return None
        self.wait_result()
        label, out = self._inflight.popleft()
        proj = self.curve.fq.from_mont(out)            # (3, L) canonical
        raw = encode_projective_result(np.asarray(proj), self.curve.spec)
        popped = self._pop_task()
        if popped is not None and popped != label:
            # FIFO divergence between the task-label queue and the
            # in-flight result queue is a framework bug, not a user error —
            # but it must not pass silently under `python -O` (a bare
            # assert would), or results get mislabeled.
            raise DeviceError(
                f"task-label FIFO out of sync: popped {popped}, "
                f"result label {label}"
            )
        return MSMResult(result=raw, label=label)

    # -------------------------------------------------------- HBM helpers
    def load_data_to_hbm(self, key: str, points) -> None:
        """Explicit point residency (msm_api.rs:299-311)."""
        spec = self.curve.spec
        if isinstance(points, (bytes, bytearray, memoryview)):
            points = decode_affine_points(points, spec)
        dev = _device_put(np.asarray(points, np.uint32), self.ctx.device)
        self._hbm_cache[key] = self._to_mont(dev)

    def get_data_from_hbm(self, key: str):
        """Read back cached points, canonical limbs (msm_api.rs:313-322)."""
        return np.asarray(self.curve.fq.jit_op("from_mont")(self._hbm_cache[key]))

    def _to_mont(self, pts):
        """Canonical (N, 2, L) device points -> Montgomery form."""
        return self.curve.fq.jit_op("to_mont")(pts)

    def is_msm_engine_ready(self) -> bool:
        return not self._inflight and self._stream is None

    def get_api(self) -> dict:
        """Register-dump analog (msm_api.rs:324-330)."""
        return {
            "pending_tasks": self.pending_tasks,
            "task_label": self.task_label,
            "streamed_elements": (
                None if self._stream is None else self._stream["consumed"]
            ),
            "timings": dataclasses.asdict(self._timings),
            "health": dataclasses.asdict(self.ctx.health()),
        }


# ============================================================== NTT client
@dataclasses.dataclass
class NTTInit:
    """ntt_api.rs analog; size is configurable here (fixed 2^27 there)."""

    field: object                  # FieldSpec or name in fields.FIELDS
    logn: int


@dataclasses.dataclass
class NTTInput:
    """ntt_api.rs:72-87 analog: raw LE bytes + host buffer index."""

    data: object                   # bytes or (n, L) canonical limbs
    buf_host: int = 0              # double-buffer slot (ntt_data.rs:54-56)


class NTTClient(DriverPrimitive):
    """Double-buffered NTT: two device slots, start/wait per slot —
    behavioral parity with the pipelined flow (integration_ntt.rs:103-136).

    Wire bytes land as flat (n, L) uint32 limbs and are converted to
    Montgomery form on the device; results convert back before the drain.
    """

    NOF_BUFFERS = 2

    def __init__(self, init: NTTInit, ctx: Optional[DeviceContext] = None,
                 inverse: bool = False):
        super().__init__()
        from ..fields import FIELDS

        self.spec: FieldSpec = (
            init.field if isinstance(init.field, FieldSpec) else FIELDS[init.field]
        )
        self.logn = init.logn
        self.ctx = ctx or DeviceContext()
        self.plan = make_ntt(self.spec, init.logn)
        self.inverse = inverse
        self._slots = [None] * self.NOF_BUFFERS      # device inputs
        self._results = [None] * self.NOF_BUFFERS    # in-flight outputs

    def loaded_binary_parameters(self) -> ImageParams:
        return ImageParams(
            "ntt",
            {
                "field": self.spec.name,
                "logn": self.logn,
                "element_bytes": self.spec.nbytes,
                "buffers": self.NOF_BUFFERS,
            },
        )

    def initialize(self, param=None) -> None:
        """No-op (the reference writes disabled debug regs, ntt_api.rs:37-56)."""

    def set_data(self, input: NTTInput) -> None:
        with timed(self._timings, "set_data_s"):
            n = 1 << self.logn
            if isinstance(input.data, (bytes, bytearray, memoryview)):
                limbs = bytes_to_limbs(input.data, self.spec)
            else:
                limbs = np.asarray(input.data, dtype=np.uint32)
            if limbs.shape[0] != n:
                raise InvalidPrimitiveParam(
                    f"want {n} elements, got {limbs.shape[0]}"
                )
            dev = _device_put(limbs, self.ctx.device)
            self._slots[input.buf_host] = self.plan.field.jit_op("to_mont")(dev)

    def start_process(self, buf_kernel: int = 0) -> None:
        """Kick the transform on a buffer (AP_CTRL start, ntt_api.rs:58-70)."""
        if self._slots[buf_kernel] is None:
            raise NotReady(f"buffer {buf_kernel} empty")
        with timed(self._timings, "start_s"):
            self._push_task()
            fn = self.plan.intt if self.inverse else self.plan.ntt
            self._results[buf_kernel] = fn(self._slots[buf_kernel])

    def wait_result(self, buf_kernel: Optional[int] = None) -> None:
        """ap_done poll analog (ntt_api.rs:89-108).  With a buffer index,
        blocks only on that buffer — the other slot keeps computing, which
        is the whole point of the double-buffered overlap
        (integration_ntt.rs:103-136)."""
        with timed(self._timings, "wait_s"):
            targets = (
                self._results
                if buf_kernel is None
                else [self._results[buf_kernel]]
            )
            for r in targets:
                if r is not None:
                    jax.block_until_ready(r)

    def result(self, buf_kernel: int = 0) -> Optional[bytes]:
        """Drain a buffer back to LE bytes (ntt_api.rs:110-125)."""
        r = self._results[buf_kernel]
        if r is None:
            return None
        self._results[buf_kernel] = None
        self._pop_task()
        canon = self.plan.field.jit_op("from_mont")(r)
        return limbs_to_bytes(np.asarray(canon), self.spec)

    def get_api(self) -> dict:
        """Register-dump analog (the NTT HLS control/status surface,
        ntt_hw_code.rs:6-83)."""
        return {
            "buffers": {
                i: ("busy" if self._results[i] is not None
                    else "staged" if self._slots[i] is not None else "empty")
                for i in range(self.NOF_BUFFERS)
            },
            "pending_tasks": self.pending_tasks,
            "timings": dataclasses.asdict(self._timings),
            "health": dataclasses.asdict(self.ctx.health()),
        }


# ========================================================== Poseidon client
@dataclasses.dataclass
class PoseidonInitializeParameters:
    """poseidon_api.rs:20-24 analog.

    The reference loads one opaque CSV instruction stream
    (poseidon_api.rs:205-243); here the leaf (t=12) and node (t=9)
    instances are separate oracle-checkable constant sets, each loadable
    from its own CSV.

    `stream_leaves` > 0 enables the reference's feed-while-hashing
    behavior (integration_poseidon.rs:81-119): every time that many
    complete leaf columns have been fed, their leaf hashes are dispatched
    immediately (async) instead of waiting for start_process — results
    become drainable (drain_stream) before the last element arrives.
    TREE_C only."""

    tree_height: int
    tree_mode: TreeMode = TreeMode.TREE_C
    instruction_path: Optional[str] = None       # leaf constants CSV
    node_instruction_path: Optional[str] = None  # node constants CSV
    stream_leaves: int = 0                       # leaves per streamed block


@dataclasses.dataclass
class PoseidonResult:
    """poseidon_api.rs:36-71 analog: 32 B hash + ids."""

    hash: bytes
    hash_id: int
    layer_id: int


class PoseidonClient(DriverPrimitive):
    def __init__(self, field="bls12_381_fr", ctx: Optional[DeviceContext] = None):
        super().__init__()
        from ..fields import FIELDS

        self.spec: FieldSpec = (
            field if isinstance(field, FieldSpec) else FIELDS[field]
        )
        self.ctx = ctx or DeviceContext()
        self._param: Optional[PoseidonInitializeParameters] = None
        self._builder: Optional[MerkleTreeBuilder] = None
        # Streamed elements accumulate as whole ARRAY chunks (not one
        # Python object per element — the reference streams 32 B records
        # by DMA, poseidon_api.rs:117-122; at 2^15-leaf scale a per-element
        # list is the client bottleneck, not the hash engine).
        self._chunks: list = []
        self._count: int = 0
        self._tree = None
        # streaming build state (stream_leaves > 0): leaf-hash chunks
        # dispatched as elements arrive; guarded by a lock so a feeder
        # thread and a drainer thread can share the client the way the
        # reference's rayon pair shares its Arc<Mutex<PoseidonClient>>
        import threading

        self._lock = threading.RLock()
        self._stream_parts: list = []   # per-block device leaf hashes
        self._stream_hashed = 0         # leaves hashed so far
        self._stream_drained = 0        # stream_parts already drained
        self._stream_off = 0            # elements consumed from _chunks[0]

    def loaded_binary_parameters(self) -> ImageParams:
        return ImageParams(
            "poseidon",
            {
                "field": self.spec.name,
                "element_bytes": self.spec.nbytes,
                "leaf_arity": LEAF_ARITY,
                "tree_arity": 8,
            },
        )

    def initialize(self, param: PoseidonInitializeParameters) -> None:
        """Reset + constants load + tree params (poseidon_api.rs:96-111)."""
        self._param = param
        leaf_params = node_params = None
        if param.instruction_path:
            leaf_params = params_from_csv(
                self.spec, param.instruction_path, LEAF_ARITY + 1
            )
        if param.node_instruction_path:
            node_params = params_from_csv(
                self.spec, param.node_instruction_path, 9
            )
        self._builder = MerkleTreeBuilder(
            self.spec, leaf_params=leaf_params, node_params=node_params
        )
        with self._lock:
            self._chunks.clear()
            self._count = 0
            self._tree = None
            self._stream_parts.clear()
            self._stream_hashed = 0
            self._stream_drained = 0
            self._stream_off = 0

    def set_data(self, data) -> None:
        """Stream elements (poseidon_api.rs:117-122); the reference feeds
        11 elements per leaf (integration_poseidon.rs:151-155).  Accepts
        one element or ANY number of elements per call — wire bytes or a
        (k, L) limb array — staged wholesale as arrays."""
        with timed(self._timings, "set_data_s"):
            limbs = (
                bytes_to_limbs(data, self.spec)
                if isinstance(data, (bytes, bytearray, memoryview))
                else np.asarray(data, dtype=np.uint32).reshape(
                    -1, self.spec.nlimbs
                )
            )
            with self._lock:
                self._chunks.append(limbs)
                self._count += limbs.shape[0]
                self._maybe_stream()

    # ------------------------------------------- streaming (feed-while-hash)
    def _take_elems(self, count: int) -> np.ndarray:
        """Consume `count` elements from the front of the chunk queue."""
        out, need = [], count
        while need:
            head = self._chunks[0]
            avail = head.shape[0] - self._stream_off
            take = min(avail, need)
            out.append(head[self._stream_off : self._stream_off + take])
            self._stream_off += take
            need -= take
            if self._stream_off == head.shape[0]:
                self._chunks.pop(0)
                self._stream_off = 0
        return out[0] if len(out) == 1 else np.concatenate(out, axis=0)

    def _dispatch_leaf_block(self, nleaf: int) -> None:
        """Hash the next `nleaf` complete leaf columns (async dispatch)."""
        arr = np.ascontiguousarray(
            self._take_elems(nleaf * LEAF_ARITY).reshape(
                nleaf, LEAF_ARITY, self.spec.nlimbs
            )
        )
        part = self._builder.hash_leaves(
            _device_put(arr.astype(np.uint32), self.ctx.device)
        )                                              # (nleaf, L) mont
        self._stream_parts.append((part, nleaf))
        self._stream_hashed += nleaf

    def _maybe_stream(self) -> None:
        """Dispatch leaf hashing for every complete streamed block.
        Caller holds the lock."""
        p = self._param
        if (p is None or p.stream_leaves <= 0
                or p.tree_mode != TreeMode.TREE_C or self._builder is None):
            return
        nleaves = base_layer_size(p.tree_height)
        while True:
            pending = self._count - self._stream_hashed * LEAF_ARITY
            take = min(p.stream_leaves, nleaves - self._stream_hashed)
            if take <= 0 or pending < take * LEAF_ARITY:
                return
            self._dispatch_leaf_block(take)

    def drain_stream(self) -> list:
        """Drain leaf records hashed so far — BEFORE start_process, like
        the reference's concurrent result loop (poseidon_api.rs:128-145,
        driven from a second thread in integration_poseidon.rs:81-119).
        Returns new PoseidonResult records since the last drain."""
        with self._lock:
            parts = self._stream_parts[self._stream_drained:]
            if not parts:
                return []
            self._stream_drained = len(self._stream_parts)
            offset = self._stream_hashed - sum(n for _, n in parts)
        f = self._builder.field
        recs = []
        for part, n in parts:
            canon = np.asarray(f.jit_op("from_mont")(part))
            for h in canon:
                recs.append(PoseidonResult(
                    hash=limbs_to_bytes(h, self.spec),
                    hash_id=offset, layer_id=0,
                ))
                offset += 1
        return recs

    def get_last_element_sent_to_ring(self) -> int:
        """Element counter (sanity-test contract,
        integration_poseidon.rs:52-56)."""
        return self._count

    def start_process(self, param=None) -> None:
        if self._param is None or self._builder is None:
            raise NotReady("initialize() first")
        h = self._param.tree_height
        nleaves = base_layer_size(h)
        want = nleaves * (LEAF_ARITY if self._param.tree_mode == TreeMode.TREE_C
                          else 1)
        if self._count < want:
            raise NotReady(
                f"need {want} elements for height {h}, have {self._count}"
            )
        with timed(self._timings, "start_s"):
            self._push_task()
            if (self._param.stream_leaves > 0
                    and self._param.tree_mode == TreeMode.TREE_C):
                # streaming build: leaves were hashed as they arrived;
                # hash the tail block and close the tree over the
                # assembled leaf layer (the reference's engine emits
                # internal layers once enough children exist — here the
                # node levels close in one dispatch)
                with self._lock:
                    remaining = nleaves - self._stream_hashed
                    if remaining:
                        self._dispatch_leaf_block(remaining)
                    leaf = (
                        self._stream_parts[0][0]
                        if len(self._stream_parts) == 1
                        else jnp.concatenate(
                            [p for p, _ in self._stream_parts], axis=0
                        )
                    )
                    self._tree = self._builder.close(leaf, h)
                return
            arr = (
                self._chunks[0]
                if len(self._chunks) == 1
                else np.concatenate(self._chunks, axis=0)
            )[:want]
            if self._param.tree_mode == TreeMode.TREE_C:
                arr = arr.reshape(nleaves, LEAF_ARITY, self.spec.nlimbs)
            self._tree = self._builder.build(arr, h, self._param.tree_mode)

    def wait_result(self) -> None:
        """Block until the async tree build completes (result-drain poll
        analog, poseidon_api.rs:128-145: layers are emitted while leaves
        stream; here they are in-flight JAX dispatches)."""
        with timed(self._timings, "wait_s"):
            if self._tree is not None:
                self._tree.block_until_ready()

    def result_arrays(self):
        """Array-speed drain: [(layer_id, (count, L) uint32 canonical)]
        per tree layer, leaf layer first.  The reference's streaming
        drain (poseidon_api.rs:128-145) at client scale — no per-node
        Python objects."""
        if self._tree is None:
            return None
        out = [
            (lid, np.asarray(layer))
            for lid, layer in enumerate(self._tree.layers)
        ]
        self._pop_task()
        return out

    def result_raw(self) -> Optional[bytes]:
        """Wire-format drain: the reference's 64 B record stream — 32 B
        LE hash + packed meta with hash_id in the low 30 bits and
        layer_id above (PoseidonResult::parse_poseidon_hash_results,
        poseidon_api.rs:42-71) — built with array ops."""
        layers = self.result_arrays()
        if layers is None:
            return None
        nbytes = self.spec.nbytes
        parts = []
        for lid, arr in layers:
            n = arr.shape[0]
            rec = np.zeros((n, 64), np.uint8)
            rec[:, :nbytes] = np.frombuffer(
                limbs_to_bytes(arr, self.spec), np.uint8
            ).reshape(n, nbytes)
            meta = (
                (np.arange(n, dtype=np.uint64) & np.uint64(0x3FFFFFFF))
                | (np.uint64(lid) << np.uint64(30))
            )
            rec[:, 32:40] = meta.astype("<u8")[:, None].view(np.uint8)
            parts.append(rec.tobytes())
        return b"".join(parts)

    def result(self, expected_count: Optional[int] = None):
        """Drain records (poseidon_api.rs:128-145)."""
        layers = self.result_arrays()
        if layers is None:
            return None
        recs = [
            PoseidonResult(
                hash=limbs_to_bytes(h, self.spec), hash_id=hid, layer_id=lid
            )
            for lid, arr in layers
            for hid, h in enumerate(arr)
        ]
        if expected_count is not None and len(recs) != expected_count:
            raise NotReady(
                f"expected {expected_count} nodes, got {len(recs)}"
            )
        return recs

    @property
    def root(self):
        return None if self._tree is None else self._tree.root

    # ---------------------------------------------- status getters (parity)
    def get_num_of_pending_results(self) -> int:
        """Undrained node count (poseidon_api.rs:156 analog).  During a
        streaming build (before start_process) this counts leaf hashes
        dispatched but not yet drained by drain_stream."""
        if self._tree is None:
            with self._lock:
                return sum(
                    n for _, n in self._stream_parts[self._stream_drained:]
                )
        return len(self._tree)

    def get_last_node_id_in_ring(self) -> int:
        """Ring last-id analog (poseidon_api.rs:149-203): nodes produced
        by the engine so far — streamed leaf hashes count as soon as
        their block is dispatched."""
        if self._tree is None:
            return self._stream_hashed
        return len(self._tree)

    def get_api(self) -> dict:
        """Register-dump analog (log_api_values,
        poseidon_api.rs:245-253 + hash_hw_code.rs:7-26)."""
        return {
            "elements_staged": self._count,
            "pending_results": self.get_num_of_pending_results(),
            "streamed_leaves": self._stream_hashed,
            "pending_tasks": self.pending_tasks,
            "timings": dataclasses.asdict(self._timings),
            "health": dataclasses.asdict(self.ctx.health()),
        }
