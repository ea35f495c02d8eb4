"""CA training on one device: the counterpart of
``kpop_tpu/parallel/sharded.py::ca_fit_sharded``.

:func:`ca_fit_sharded` keeps the JAX function's signature, less the mesh
and plus an explicit device, and its returns.  The TPU has no float64, so
the JAX package rebuilds the standardized residual

    S[k, j] = x[k, j] alpha[k] beta[j] - u[k] v[j]

in double-double f32 limbs and sums ``S^T S`` with a Kahan carry.  The port
does what those functions compute in float64, without the limbs:

- the masses in host float64, with the column weights folded into beta;
- the table uploaded once in its smallest exact wire type (u8, u16, f32,
  or f64 for tables that are signed or not exactly f32-representable);
- the Gram from the fused residual-Gram kernel (:mod:`..ops.gram`),
  downloaded in float64;
- the host float64 ``eigh`` of the ``[ns, ns]`` Gram, with the JAX
  package's sign and inertia conventions (:func:`_factor_gram_host`);
- phi = ``(S V / sv) rs`` in row blocks: S rebuilt in float64 by the plain
  function, a float64 ``torch.matmul`` with ``V / sv``; with
  ``phi="device"`` the twister stays on the device as ``[K, d]`` f32, with
  ``phi="host"`` each float64 block is copied to the host as it is made
  (the JAX package brings phi to the host block by block too).

``precision="fast"`` is the JAX ``_ca_math``: everything on the device in
f32, ``torch.linalg.eigh`` included.

A fit whose resident footprint exceeds the device budget
(:func:`_hbm_budget`) streams (:func:`_ca_fit_streamed`, the counterpart of
the JAX function of that name): the wire table goes to the card in row
blocks, two at a time, once for the Gram and once more for phi, so the
device holds a few blocks and never the table.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..ops import gram

#: set by the last dd-path ca_fit_sharded call: the wire type of the
#: uploaded table, "u8"/"u16"/"f32" on the compact path, "f64" on the
#: fallback for signed or f32-inexact tables
LAST_DD_UPLOAD: str | None = None
#: seconds per phase of the last dd-path fit (masses, upload, gram, eigh,
#: phi; a streamed fit's gram and phi passes hold their uploads and it has
#: no upload phase), the device synchronized at each mark
LAST_CA_PHASES: dict[str, float] = {}
#: the geometry of the last dd-path fit if it streamed, else None: the wire
#: type, rows a block, blocks, the budget, a wire block's bytes and the
#: wire blocks live at once (the JAX package's keys), and the device bytes
#: the blocks were sized to (``footprint_bytes``) with phi's sub-block rows
LAST_CA_STREAM: dict | None = None
#: bytes an entry of each wire type
WIRE_BYTES = {"u8": 1, "u16": 2, "f32": 4, "f64": 8}
#: what the caching allocator may add to a streamed fit's tensors: each of
#: its two dozen is rounded up to 512 bytes
ALLOC_SLACK = 24 * 512


class _PhaseTimer:
    """Per-phase wall times of :func:`ca_fit_sharded` into
    :data:`LAST_CA_PHASES`, printed to stderr when ``KPOP_CA_DEBUG`` is set
    or the fit is verbose.  A mark waits for the device first, so a phase
    holds its own device work."""

    def __init__(self, label: str, device: torch.device, verbose: bool):
        self.on = verbose or bool(os.environ.get("KPOP_CA_DEBUG"))
        self.label = label
        self.device = device
        LAST_CA_PHASES.clear()
        self.t = time.perf_counter()

    def mark(self, phase: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        LAST_CA_PHASES[phase] = now - self.t
        if self.on:
            sys.stderr.write("%s[%s]: %.2f s\n" % (self.label, phase, now - self.t))
            sys.stderr.flush()
        self.t = now


def _ca_math(table: torch.Tensor, n_dims: int, d_full: int):
    """The CA factorization of a ``[K, ns]`` f32 table, all on its device
    (the JAX ``_ca_math``, the "fast" path)."""
    total = table.sum()
    P_ = table / total
    r = P_.sum(dim=1)
    c = P_.sum(dim=0)
    r_safe = torch.where(r > 0, r, torch.ones_like(r))
    c_safe = torch.where(c > 0, c, torch.ones_like(c))
    S = (P_ - r[:, None] * c[None, :]) / torch.sqrt(r_safe[:, None] * c_safe[None, :])
    evals, evecs = torch.linalg.eigh(S.T @ S)  # ascending
    evals, evecs = evals.flip(0), evecs.flip(1)
    total_in = torch.clamp(evals[:d_full], min=0.0).sum()
    evals = torch.clamp(evals[:n_dims], min=0.0)
    V = evecs[:, :n_dims]
    sv = torch.sqrt(evals)
    # deterministic sign: largest-|.| component of each column positive
    amax = torch.argmax(torch.abs(V), dim=0)
    signs = torch.sign(V[amax, torch.arange(n_dims, device=V.device)])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    V = V * signs[None, :]
    sample_coords = V * sv[None, :] / torch.sqrt(c_safe)[:, None]
    sv_safe = torch.where(sv > 0, sv, torch.ones_like(sv))
    phi = (S @ (V / sv_safe[None, :])) / torch.sqrt(r_safe)[:, None]
    phi = torch.where((r > 0)[:, None], phi, torch.zeros_like(phi))
    inertia = evals / total_in if total_in > 0 else evals
    return sample_coords, inertia, phi, sv


def _compact_exact_cast(table: np.ndarray):
    """Return ``(compact_array, kind)`` when every table value is exactly
    representable in float32 — ``kind`` in {"u8", "u16", "f32"} picks the
    smallest wire dtype — else ``(None, None)``.  One blocked pass."""
    if table.dtype == np.float32:
        # the compact residual path masks alpha to rows with r > 0, which is
        # only equivalent to the fallback's divide-by-r_safe when entries
        # cannot cancel — require nonnegativity (counts are nonnegative by
        # construction; signed tables take the exact two-limb fallback)
        if table.size and not (table >= 0).all():
            return None, None
        kind_arr = table
        is_int, mx, mn = False, None, None
        # still probe integrality/range for a smaller wire dtype
        is_int = bool((table == np.floor(table)).all())
        if is_int and table.size:
            mx = float(table.max())
    elif np.issubdtype(table.dtype, np.integer):
        mn = int(table.min()) if table.size else 0
        mx = int(table.max()) if table.size else 0
        if mn < 0 or mx >= (1 << 24):
            return None, None
        is_int, kind_arr = True, table
    elif table.dtype == np.float64:
        step = max(1, (8 << 20) // max(1, int(table.shape[1])))
        is_int, mx = True, 0.0
        for i in range(0, table.shape[0], step):
            blk = table[i : i + step]
            if not np.array_equal(blk, blk.astype(np.float32)):
                return None, None
            if blk.size and not (blk >= 0).all():  # see float32 case above
                return None, None
            if is_int and not (blk == np.floor(blk)).all():
                is_int = False
            m = float(blk.max()) if blk.size else 0.0
            mx = m if m > mx else mx
        kind_arr = table
    else:
        return None, None
    if is_int and mx is not None and mx < 256:
        return kind_arr.astype(np.uint8), "u8"
    if is_int and mx is not None and mx < 65536:
        return kind_arr.astype(np.uint16), "u16"
    return kind_arr.astype(np.float32), "f32"


def _hbm_budget(device: torch.device) -> int | None:
    """Device residency budget of the CA in bytes: ``KPOP_CA_HBM_BYTES``
    when set (0 or less disables budgeting), else 60 % of the card's memory
    (``torch.cuda.mem_get_info``), else None (the CPU: unbudgeted)."""
    env = os.environ.get("KPOP_CA_HBM_BYTES")
    if env:
        try:
            val = int(float(env))
        except ValueError:
            sys.stderr.write(
                "ca_fit_sharded: ignoring unparseable KPOP_CA_HBM_BYTES=%r; "
                "using the default budget\n" % env
            )
        else:
            return val if val > 0 else None
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1] * 0.6)
    return None


def _factor_gram_host(G: np.ndarray, d: int, c_safe: np.ndarray,
                      d_full: int):
    """Host float64 eigendecomposition of the [ns, ns] Gram + the CA output
    conventions (descending order, deterministic column signs, principal
    sample coordinates) — shared by both dd upload paths.

    ``d_full`` = min(nk, ns) - 1, the non-trivial spectrum size: inertia is
    normalized over the top ``d_full`` eigenvalues BEFORE truncating to
    ``d``, so n_dims-truncated fits report each dim's share of the whole
    (R ca()'s sv^2/sum(sv^2)), not of the kept dims — and the trailing
    eigenvalue (exactly zero in exact arithmetic) stays out of the total.
    """
    evals, evecs = np.linalg.eigh(G)
    order = np.argsort(evals)[::-1]
    ev_desc = evals[order]
    total_in = float(np.maximum(ev_desc[: max(1, d_full)], 0.0).sum())
    evals, evecs = ev_desc[:d], evecs[:, order][:, :d]
    evals = np.maximum(evals, 0.0)
    sv = np.sqrt(evals)
    signs = np.sign(evecs[np.argmax(np.abs(evecs), axis=0), np.arange(d)])
    signs = np.where(signs == 0, 1.0, signs)
    V = evecs * signs[None, :]
    sample_coords = V * sv[None, :] / np.sqrt(c_safe)[:, None]
    sv_safe = np.where(sv > 0, sv, 1.0)
    inertia = evals / total_in if total_in > 0 else evals
    return sample_coords, inertia, sv, V, sv_safe


def residual_vectors(N: np.ndarray, w: np.ndarray | None):
    """The masses of a ``[K, ns]`` table in host float64 (column weights
    ``w`` folded in, not applied) and the residual's scaling vectors:
    returns ``(alpha, u, beta, v, r, c_safe)`` with S = N alpha beta - u v,
    alpha = 1/sqrt(r_safe), u = sqrt(r), beta = w / (total sqrt(c_safe)),
    v = c / sqrt(c_safe)."""
    if w is None:
        roww = N.sum(axis=1, dtype=np.float64)
        colw = N.sum(axis=0, dtype=np.float64)
    else:
        # blocked N @ w: a whole-table astype(float64) would double the
        # table's memory (8 B/entry)
        roww = np.empty(N.shape[0], dtype=np.float64)
        step = max(1, (64 << 20) // max(1, N.shape[1] * 8))
        for i in range(0, N.shape[0], step):
            roww[i : i + step] = N[i : i + step].astype(np.float64) @ w
        colw = N.sum(axis=0, dtype=np.float64) * w
    total = float(roww.sum())
    r = roww / total
    c = colw / total
    r_safe = np.where(r > 0, r, 1.0)
    c_safe = np.where(c > 0, c, 1.0)
    inv_sr = 1.0 / np.sqrt(r_safe)
    inv_sc = 1.0 / np.sqrt(c_safe)
    beta = (w if w is not None else 1.0) * inv_sc / total
    return inv_sr, r * inv_sr, beta, c * inv_sc, r, c_safe


def ca_fit_sharded(
    table: np.ndarray,
    n_dims: int | None = None,
    precision: str = "dd",
    phi: str = "host",
    block_bytes: int = 64 << 20,
    col_weights: np.ndarray | None = None,
    hbm_bytes: int | None = None,
    verbose: bool = False,
    device: torch.device | str | None = None,
    _stream_probe=None,
):
    """Fit CA on one device.

    ``table``: host [n_kmers, n_samples].  Returns (sample_coords, inertia,
    twister, sv): host arrays, except that with ``phi="device"`` the twister
    comes back as the device-resident ``[K, d]`` float32 tensor (k-mers x
    dims, table row order) instead of the host ``[d, K]`` transpose, and
    feeds serving (``ClassifierParams.twister``) without a download.

    ``precision="dd"`` (default): float64 CA factors (see the module
    docstring); :data:`LAST_DD_UPLOAD` records the wire type and
    :data:`LAST_CA_PHASES` the wall time of each phase.  ``block_bytes``
    bounds each float64 row block of S in the phi product.
    ``precision="fast"``: everything on the device in float32.

    ``col_weights``: optional per-column multipliers applied to the table
    (KPopTwist's per-spectrum normalization), folded into the
    column vector so that an integer table keeps its compact wire.

    ``hbm_bytes``: device residency budget (default :func:`_hbm_budget`;
    0 disables it).  The resident footprint is the wire table, two blocks
    of S's size (a block of S and the outer product it subtracts while it
    is made) and two phi blocks (the one being made and the one in copy, or
    being written into the twister), plus the f32 twister with
    ``phi="device"``.  A fit whose resident footprint exceeds the budget
    streams (:func:`_ca_fit_streamed`; :data:`LAST_CA_STREAM` records its
    blocks), with the same outputs.  ``verbose`` prints the phase times to
    stderr.
    ``_stream_probe`` (a test hook) is called once for each block a
    streamed fit retires.
    """
    from ..config import device as default_device

    device = default_device() if device is None else torch.device(device)
    nk, ns = table.shape
    # cap at the non-trivial spectrum (see core/ca.py::fit_ca): an
    # over-large n_dims would keep a pure-noise phi column
    d_full = max(1, min(nk, ns) - 1)
    d = d_full if n_dims is None else max(1, min(n_dims, d_full))
    if phi not in ("host", "device"):
        raise ValueError(f"unknown phi placement {phi!r}")
    if precision == "fast":
        if col_weights is not None:
            table = np.asarray(table) * np.asarray(col_weights)[None, :]
        xs = torch.as_tensor(np.ascontiguousarray(table, dtype=np.float32), device=device)
        coords, inertia, phi_d, sv = _ca_math(xs, d, d_full)
        tw = phi_d if phi == "device" else phi_d.cpu().numpy().T
        return coords.cpu().numpy(), inertia.cpu().numpy(), tw, sv.cpu().numpy()
    if precision != "dd":
        raise ValueError(f"unknown CA precision {precision!r}")
    global LAST_DD_UPLOAD, LAST_CA_STREAM
    LAST_CA_STREAM = None
    tm = _PhaseTimer("ca_fit_sharded", device, verbose)
    N = np.asarray(table)
    w = None if col_weights is None else np.asarray(col_weights, dtype=np.float64)
    alpha, u, beta, v, r, c_safe = residual_vectors(N, w)
    # phi's row scale; on the compact path alpha is masked to rows with
    # r > 0 too, which equals the fallback's 1/sqrt(r_safe) only for
    # nonnegative tables (signed tables take the fallback)
    rs = alpha * (r > 0)
    tm.mark("masses")
    # the compact wire when every value is exactly f32-representable, else
    # the f64 table: 8 B an entry, as the JAX fallback's two f32 limbs
    compact, kind = _compact_exact_cast(N)
    if compact is None:  # the f64 wire: cast as it is uploaded
        compact, kind = N, "f64"
    else:
        alpha = rs
    # phi's f64 row blocks of S, at most block_bytes each
    step = max(1, block_bytes // max(1, ns * 8))
    budget = hbm_bytes if hbm_bytes is not None else _hbm_budget(device)
    # the wire table; S and its outer product, the phi block being made and
    # the one in copy (or being written into the twister); the f32 twister
    resident = nk * ns * WIRE_BYTES[kind] + min(step, nk) * (2 * ns + 2 * d) * 8
    if phi == "device":
        resident += nk * d * 4
    LAST_DD_UPLOAD = kind
    if budget and resident > budget:
        return _ca_fit_streamed(
            compact, kind, d, d_full, (alpha, u, beta, v, rs, c_safe), phi, budget, step,
            device, tm, _stream_probe,
        )

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    x = up(compact if kind != "f64" else np.asarray(compact, dtype=np.float64))
    alpha_d, u_d, beta_d, v_d = (up(np.asarray(a, np.float64)) for a in (alpha, u, beta, v))
    tm.mark("upload")
    G = gram.residual_gram(x, alpha_d, u_d, beta_d, v_d).cpu().numpy()
    if not np.isfinite(G).all():
        raise FloatingPointError("ca_fit_sharded: the Gram of the residual is not finite")
    tm.mark("gram")
    sample_coords, inertia, sv, V, sv_safe = _factor_gram_host(G, d, c_safe, d_full)
    tm.mark("eigh")
    # phi = (S V / sv) rs in row blocks of at most block_bytes of f64 S
    Vs = up(V / sv_safe[None, :])
    rs_d = up(rs)

    def phi_block(i: int, j: int) -> torch.Tensor:
        S = gram.residual(x[i:j], alpha_d[i:j], u_d[i:j], beta_d, v_d)
        # scaled in place: no third [rows, d] block beside the budget's two
        return torch.matmul(S, Vs).mul_(rs_d[i:j, None])

    if phi == "device":
        tw = torch.empty((nk, d), dtype=torch.float32, device=device)
        for i in range(0, nk, step):
            tw[i : i + step] = phi_block(i, min(nk, i + step))
    else:
        tw = _blocks_to_host(phi_block, nk, d, _ranges(0, nk, step), device).T
    tm.mark("phi")
    return sample_coords, inertia, tw, sv


def _ranges(i: int, j: int, step: int) -> list[tuple[int, int]]:
    """Rows ``[i, j)`` in consecutive ranges of at most ``step``."""
    return [(a, min(j, a + step)) for a in range(i, j, step)]


def _stream_footprint(rows: int, ns: int, d: int, wire_bytes: int, sub_step: int,
                      n_sm: int) -> int:
    """Device bytes of a streamed fit with wire blocks of ``rows`` rows:
    two blocks of the wire table and of the three float64 row vectors
    (alpha, u and phi's row scale), beta and v; then the larger of the two
    passes: the Gram pass's accumulator, which holds its split-K partials
    for the whole pass, and G (:func:`~..ops.gram.accumulator_doubles`), or
    the phi pass's V / sv, two blocks of S's size and two phi
    blocks, in sub-blocks of at most ``sub_step`` rows; and
    :data:`ALLOC_SLACK`."""
    blocks = 2 * rows * (ns * wire_bytes + 3 * 8) + 2 * ns * 8 + ALLOC_SLACK
    gram_pass = gram.accumulator_doubles(rows, ns, n_sm) * 8
    phi_pass = (ns * d + 2 * min(sub_step, rows) * (ns + d)) * 8
    return blocks + max(gram_pass, phi_pass)


def _stream_block_rows(budget: int, nk: int, ns: int, d: int, wire_bytes: int,
                       sub_step: int, n_sm: int) -> int:
    """The most rows a wire block may hold with :func:`_stream_footprint`
    within ``budget`` (at least one, with a warning when even one row is
    above it)."""
    def fits(rows: int) -> bool:
        return _stream_footprint(rows, ns, d, wire_bytes, sub_step, n_sm) <= budget

    if not fits(1):
        sys.stderr.write(
            "ca_fit_sharded: KPOP_CA_HBM_BYTES=%d is below the smallest streamed "
            "block (%d B); streaming one row a block\n"
            % (budget, _stream_footprint(1, ns, d, wire_bytes, sub_step, n_sm))
        )
        return 1
    lo, hi = 1, nk  # fits(lo) holds throughout
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


class _Staging:
    """Two slots of pinned host buffers and a side stream that copies between
    them and the device: the double buffering of :class:`_BlockStream` (host
    to device) and :func:`_blocks_to_host` (device to host).  A slot's host
    buffers are handed out again only once its last copy is done
    (:meth:`claim`), so the host works on one slot while the other is in
    flight."""

    def __init__(self, specs, device: torch.device):
        self.host = [[torch.empty(shape, dtype=dt, pin_memory=True) for shape, dt in specs]
                     for _ in range(2)]
        self.copier = torch.cuda.Stream(device)
        self.done: list = [None, None]  # the slot's last copy done

    def claim(self, slot: int) -> list[torch.Tensor]:
        """The slot's host buffers, once its last copy is done."""
        if self.done[slot] is not None:
            self.done[slot].synchronize()
            self.done[slot] = None
        return self.host[slot]

    def copy(self, slot: int, pairs, after) -> torch.cuda.Event:
        """``dst.copy_(src)`` for each ``(dst, src)`` of ``pairs`` on the side
        stream, once the event ``after`` (if any) is done; returns the event
        of the slot's copies."""
        with torch.cuda.stream(self.copier):
            if after is not None:
                self.copier.wait_event(after)
            for dst, src in pairs:
                dst.copy_(src, non_blocking=True)
            self.done[slot] = self.copier.record_event()
        return self.done[slot]


class _BlockStream:
    """Row blocks of host arrays uploaded in turn into two device buffers.

    ``sources`` are ``(array, torch dtype)`` pairs of host arrays of the same
    rows.  :meth:`get` makes a block of rows resident and returns its device
    views.  On a card each block is cast (or copied, when the source has its
    dtype already) on the host into a slot of :class:`_Staging` and copied on
    its side stream into one of two device buffers, so the upload of a block
    overlaps the work the caller enqueued on the block before it; a device
    buffer is written again only once the work enqueued on it is done.  On
    the CPU each block is cast straight into its buffer."""

    def __init__(self, sources, rows: int, device: torch.device):
        self.sources = sources
        self.device = device
        self.cuda = device.type == "cuda"
        self.dev = [[torch.empty((rows,) + a.shape[1:], dtype=dt, device=device)
                     for a, dt in sources] for _ in range(2)]
        self.slot = 1
        if self.cuda:
            self.staging = _Staging([((rows,) + a.shape[1:], dt) for a, dt in sources], device)
            self.freed: list = [None, None]  # the work on the slot's device buffers done

    def get(self, i: int, j: int) -> list[torch.Tensor]:
        """Device views of rows ``[i, j)`` of each source; the buffers of
        the block before are released once the work enqueued on them by
        now is done."""
        n = j - i
        if self.cuda:
            self.freed[self.slot] = torch.cuda.current_stream(self.device).record_event()
        self.slot = slot = 1 - self.slot
        bufs = self.staging.claim(slot) if self.cuda else self.dev[slot]
        for (a, _), buf in zip(self.sources, bufs):
            np.copyto(buf[:n].numpy(), a[i:j], casting="unsafe")
        if self.cuda:
            done = self.staging.copy(
                slot, [(dv[:n], h[:n]) for dv, h in zip(self.dev[slot], bufs)], self.freed[slot])
            torch.cuda.current_stream(self.device).wait_event(done)
        return [buf[:n] for buf in self.dev[slot]]


def _ca_fit_streamed(wire_table, kind: str, d: int, d_full: int, vectors: tuple, phi: str,
                     budget: int, step: int, device: torch.device, tm: _PhaseTimer,
                     on_block=None):
    """The CA fit of :func:`ca_fit_sharded` in row blocks, within
    ``budget`` bytes of device memory: the counterpart of the JAX
    ``_ca_fit_streamed``.

    ``wire_table`` is the host table on its wire (``kind``; for ``"f64"``
    the table itself, cast block by block) and ``vectors`` the masses
    ``(alpha, u, beta, v, rs, c_safe)``.  Pass 1 uploads each block
    (:class:`_BlockStream`) and adds its Gram into one float64 G
    (``csrc/ca_gram.cu``, accumulating), so the blocks' Grams are summed
    in block order; the host factors G.  Pass 2 uploads each block again
    and makes its phi rows in sub-blocks of at most ``step`` rows (S
    rebuilt in float64, a float64 ``torch.matmul`` with V / sv), kept in
    the ``[K, d]`` f32 twister on the device with ``phi="device"`` or
    copied to the host as they are made with ``phi="host"``.  The blocks
    are sized by :func:`_stream_footprint`; with ``phi="device"`` the
    twister, the requested output, comes first out of the budget when it
    fits in it, and a warning names ``phi="host"`` when it does not.
    ``on_block`` is called once for each block retired."""
    global LAST_CA_STREAM
    alpha, u, beta, v, rs, c_safe = vectors
    nk, ns = wire_table.shape
    wire_bytes = WIRE_BYTES[kind]
    twister_bytes = nk * d * 4 if phi == "device" else 0
    if twister_bytes > budget:
        sys.stderr.write(
            "ca_fit_sharded: phi='device' keeps the full [%d, %d] f32 twister on the "
            "device (%d B, above the %d B budget); use phi='host'\n"
            % (nk, d, twister_bytes, budget)
        )
    avail = budget - twister_bytes if twister_bytes <= budget else budget
    n_sm = gram._sm_count(device) if device.type == "cuda" else gram.H100_SMS
    rows = _stream_block_rows(avail, nk, ns, d, wire_bytes, step, n_sm)
    blocks = _ranges(0, nk, rows)
    LAST_CA_STREAM = {
        "wire": kind,
        "block_rows": rows,
        "n_blocks": len(blocks),
        "budget_bytes_per_device": budget,
        "block_bytes_per_device": rows * ns * wire_bytes,
        "max_live_blocks": 2,
        "footprint_bytes": _stream_footprint(rows, ns, d, wire_bytes, step, n_sm) + twister_bytes,
        "sub_block_rows": min(step, rows),
    }
    f64 = torch.float64
    wire_dtype = {"u8": torch.uint8, "u16": torch.uint16, "f32": torch.float32, "f64": f64}[kind]
    stream = _BlockStream(
        [(wire_table, wire_dtype), (alpha, f64), (u, f64), (rs, f64)], rows, device)
    beta_d, v_d = (torch.as_tensor(np.asarray(a, np.float64), device=device) for a in (beta, v))

    # pass 1: G = sum_b S_b^T S_b, the partials kept across the blocks
    acc = gram.GramAccumulator(beta_d, v_d, rows)
    for i, j in blocks:
        x, a, uu, _ = stream.get(i, j)
        acc.add(x, a, uu)
        if on_block is not None:
            on_block()
    G = acc.finish().cpu().numpy()
    del acc
    if not np.isfinite(G).all():
        raise FloatingPointError("ca_fit_sharded: the Gram of the residual is not finite")
    tm.mark("gram")
    sample_coords, inertia, sv, V, sv_safe = _factor_gram_host(G, d, c_safe, d_full)
    tm.mark("eigh")

    # pass 2: phi = (S V / sv) rs, each block uploaded again
    Vs = torch.as_tensor(V / sv_safe[None, :], device=device)
    current: dict = {}  # the resident block: its first row and device views

    def phi_rows(i: int, j: int) -> torch.Tensor:
        i0, j0 = blocks[i // rows]
        if current.get("first") != i0:
            if current and on_block is not None:
                on_block()
            current.update(first=i0, views=stream.get(i0, j0))
        x, a, uu, r = (t[i - i0 : j - i0] for t in current["views"])
        S = gram.residual(x, a, uu, beta_d, v_d)
        # scaled in place: no third block beside the two the budget counts
        return torch.matmul(S, Vs).mul_(r[:, None])

    sub = [r for i, j in blocks for r in _ranges(i, j, step)]
    if phi == "device":
        tw = torch.empty((nk, d), dtype=torch.float32, device=device)
        for i, j in sub:
            tw[i:j] = phi_rows(i, j)
    else:
        tw = _blocks_to_host(phi_rows, nk, d, sub, device).T
    if on_block is not None:
        on_block()
    tm.mark("phi")
    return sample_coords, inertia, tw, sv


def _blocks_to_host(make_block, nk: int, d: int, ranges, device: torch.device) -> np.ndarray:
    """The ``[nk, d]`` float64 rows ``make_block(i, j)`` for consecutive
    row ``ranges`` ``(i, j)`` that cover them, gathered on the host as they
    are made.  On a card each block is copied on the side stream of
    :class:`_Staging` into one of its slots, so the copy of a block overlaps
    the making of the next; the host copies a slot out only when it is
    needed again.  A device block lives until its copy is done."""
    out = np.empty((nk, d), dtype=np.float64)
    if device.type != "cuda":
        for i, j in ranges:
            out[i:j] = make_block(i, j).numpy()
        return out
    staging = _Staging([((max(j - i for i, j in ranges), d), torch.float64)], device)
    pending: list = [None, None]  # per slot: (i, j, device block) of its copy

    def drain(slot: int) -> torch.Tensor:
        (buf,) = staging.claim(slot)
        if pending[slot] is not None:
            i, j, _ = pending[slot]
            out[i:j] = buf[: j - i].numpy()
            pending[slot] = None
        return buf

    for n, (i, j) in enumerate(ranges):
        slot = n % 2
        buf = drain(slot)
        block = make_block(i, j)
        staging.copy(slot, [(buf[: j - i], block)],
                     torch.cuda.current_stream(device).record_event())
        pending[slot] = (i, j, block)
    for slot in (0, 1):
        drain(slot)
    return out
