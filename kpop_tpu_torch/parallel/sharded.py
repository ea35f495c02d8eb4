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
  ``phi="device"`` the twister stays on the device as ``[K, d]`` f32.

``precision="fast"`` is the JAX ``_ca_math``: everything on the device in
f32, ``torch.linalg.eigh`` included.  The HBM-budgeted streamed path
(``_ca_fit_streamed``) is not ported yet: a fit whose resident footprint
exceeds the budget raises.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..ops import gram

STREAMED_NOTE = (
    "the streamed CA path (_ca_fit_streamed) is not ported to "
    "kpop_tpu_torch yet (ROADMAP.md, queue 1)"
)

#: set by the last dd-path ca_fit_sharded call: the wire type of the
#: uploaded table, "u8"/"u16"/"f32" on the compact path, "f64" on the
#: fallback for signed or f32-inexact tables
LAST_DD_UPLOAD: str | None = None
#: seconds per phase of the last dd-path fit (masses, upload, gram, eigh,
#: phi), the device synchronized at each mark
LAST_CA_PHASES: dict[str, float] = {}


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
    0 disables it).  A fit whose resident table and twister exceed it
    raises ``NotImplementedError``: the streamed path is not ported yet.
    ``verbose`` prints the phase times to stderr.
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
    global LAST_DD_UPLOAD
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
    if compact is None:
        compact, kind = np.asarray(N, dtype=np.float64), "f64"
    else:
        alpha = rs
    out_dt = torch.float32 if phi == "device" else torch.float64
    budget = hbm_bytes if hbm_bytes is not None else _hbm_budget(device)
    resident = nk * (ns * compact.itemsize + d * out_dt.itemsize)
    if budget and resident > budget:
        raise NotImplementedError(
            f"ca_fit_sharded: the resident table and twister need {resident} "
            f"bytes of device memory, above the budget of {budget} "
            f"(KPOP_CA_HBM_BYTES); {STREAMED_NOTE}"
        )
    LAST_DD_UPLOAD = kind

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    x = up(compact)
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
    tw = torch.empty((nk, d), dtype=out_dt, device=device)
    step = max(1, block_bytes // max(1, ns * 8))
    for i in range(0, nk, step):
        j = min(nk, i + step)
        S = gram.residual(x[i:j], alpha_d[i:j], u_d[i:j], beta_d, v_d)
        tw[i:j] = (S @ Vs) * rs_d[i:j, None]
    if phi == "host":
        tw = tw.cpu().numpy().T
    tm.mark("phi")
    return sample_coords, inertia, tw, sv
