"""``kpop-classify-torch``: one-shot FASTA/FASTQ -> distance summaries, with
the device step in PyTorch.

The counterpart of ``kpop_tpu/cli/classify.py``: the same options and the
same ``.KPopSummary.txt`` output.  Distances are computed on the device in
float32 (:mod:`kpop_tpu_torch.ops.pipeline`) and the summary statistics on
the host in float64 over each full distance row
(``kpop_tpu/core/space.py::summarize_distance_row``).  The device is the
one ``KPOP_PLATFORM`` names (:func:`kpop_tpu_torch.config.device`).
Minkowski distances take the exact host path, as in the JAX tool.
``--dtype bf16`` stores the twister in bf16 on the device (every sum stays
f32).

Run by ``torchrun --nproc-per-node N`` (or with the ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` it sets), the tool
serves over the N ranks, as the JAX tool serves over several devices
(``kpop_tpu/cli/classify.py:277-334``): ``--kmer-parallel`` ranks (it must
divide N), or with none as many as the twister needs to fit
``KPOP_PARAMS_HBM_BYTES`` a rank (default 8 GiB;
:func:`~..parallel.serving.choose_kmer_parallel`), share the twister's rows
(:mod:`..parallel.serving`), the rest split each batch by rows with the
parameters replicated.  The backend is ``nccl`` where each rank has a card
of its own and ``gloo`` on the CPU or where ranks share a card
(:func:`~..parallel.distributed.default_backend`).  Rank 0 alone writes the
summaries.  On one rank ``--kmer-parallel`` has no effect, as in the JAX
tool on one device.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

import numpy as np
import torch

from ..core.kmers import _DNA_CODE, _PROT_CODE, KmerSpace
from ..core.matrix import KPopMatrix, MatrixType
from ..core.space import Distance, Metric, summarize_distance_row
from ..core.twister import Twister
from ..io.reads import (
    FastaInput,
    PairedEndFastqInput,
    SingleEndFastqInput,
    iter_reads,
)
from ..utils.cli import Args, ParseError, Parser
from ..utils.naming import SUMMARY_EXT, close_if_owned, open_out, with_ext
from ..utils.progress import set_verbose

from .. import __version__, trace
from ..config import device
from ..parallel import distributed
from ..parallel.mesh import Layout, all_gather_rows, make_mesh
from ..ops.encode import (
    ByteRing,
    PackedReads,
    encode_bytes,
    encode_reads_host,
    pack_reads_2bit,
    packed_strides,
)
from ..ops.pipeline import (
    ClassifierParams,
    build_classifier_params,
    check_whole_twister,
    count_plan,
    count_spectra,
    distances_to_classes,
    project,
    project_reads,
)


class AmbiguousK(ValueError):
    pass


def infer_k(
    content: str, kmer_names: list[str], k: int = 0, verbose: bool = False
) -> int:
    """Infer (or validate) k from the twister's hex k-mer labels.

    Hex width alone is not injective in k (e.g. DNA k=5 and k=6 both use 3
    hex digits), so every candidate with the right width is checked against
    the labels' maximum code; a supplied ``k`` is validated the same way and
    a mismatch is a hard error rather than silent misclassification.  When
    several k remain consistent the smallest is used with a warning — pass
    ``-k`` to silence it.
    """
    if not kmer_names:
        raise AmbiguousK("twister has no k-mer labels; pass -k")
    width = len(kmer_names[0])
    max_code = max(int(n, 16) for n in kmer_names)
    k_limit = 30 if content.startswith("DNA") else 12
    if k:
        sp = KmerSpace(content, k)
        if sp.hex_width != width or max_code >= sp.n_kmers:
            raise AmbiguousK(
                f"k={k} is inconsistent with the twister's labels "
                f"(width {width}, max code {max_code:#x}); "
                f"expected width {sp.hex_width}, codes < {sp.n_kmers:#x}"
            )
        return k
    consistent = [
        c
        for c in range(1, k_limit + 1)
        if KmerSpace(content, c).hex_width == width
        and max_code < KmerSpace(content, c).n_kmers
    ]
    if not consistent:
        raise AmbiguousK(
            f"cannot infer k from labels (width {width}, max code "
            f"{max_code:#x}); pass -k"
        )
    k = consistent[0]
    if len(consistent) > 1:
        sys.stderr.write(
            f"(KPopClassify): WARNING k is ambiguous from labels alone "
            f"(candidates {consistent}); using k={k} — pass -k to override\n"
        )
    elif verbose:
        sys.stderr.write(f"(KPopClassify): inferred k={k}\n")
    return k


def pick_path(B: int, W: int, V: int, d: int) -> str:
    """'dense' or 'bag' by estimated memory traffic per batch: dense touches
    the [B, V] spectrum ~3x (zero + scatter + product read) plus the [V, d]
    twister; bag gathers B*W rows of 4d bytes, weighted 16x for the poor
    efficiency of small gathers.  The constants were fitted on a TPU v5e
    for the JAX package and are kept as they are; re-fitting them on the
    H100 is later work."""
    bag_bytes = 4 * B * W * d * 16
    dense_bytes = 12 * B * V + 4 * V * d
    return "bag" if bag_bytes < dense_bytes else "dense"


def dmat_step(params: ClassifierParams, base_codes, path: str):
    """``[B, L]`` base codes (or :class:`~..ops.encode.PackedReads`) ->
    ``[B, C]`` distances to the classes, through the dense route (count,
    then the twister product over each read set's integer count of known
    windows) or the bag."""
    check_whole_twister("dmat_step", params)
    if path == "bag":
        twisted = project_reads(params, base_codes)
    else:
        spectra, known = count_spectra(params, base_codes, known=True)
        twisted = project(params, spectra, known=known)
    return distances_to_classes(params, twisted)


class DeviceStep:
    """Stage a batch on the host, upload this rank's rows of it, compute
    their distances and start the download, without waiting.

    ``mesh`` is the rank layout (:class:`~..parallel.mesh.Layout`; one rank
    by default): the batch is padded with empty rows (all ``-1`` codes,
    empty spectra) to a multiple of the data axis and each rank serves its
    data group's rows; :meth:`materialize` gathers the groups' rows
    through the host, in order.  ``dmat`` maps ``(params, codes)`` to the
    ``[B, C]`` distances; by default :func:`dmat_step` over ``path``
    (``"auto"`` is pinned by :func:`pick_path` on the first batch).

    On a card the batch is uploaded from pinned memory without blocking,
    and the result is copied without blocking into pinned host memory with
    an event recorded behind it; :meth:`materialize` waits on that event
    alone.  ``tensor.cpu()`` would also wait for any batch dispatched after
    this one, and the serve loop keeps one batch in flight so that the host
    formats one batch while the card computes the next.

    ``wire`` is what crosses to the card:

    - ``"bytes"`` (the default where the parameters lie on a card): the
      rank's sequences as raw UTF-8 bytes, one a base, staged in a ring of
      two reused pinned buffers (:class:`~..ops.encode.ByteRing`), then
      linted and encoded on the card (:func:`~..ops.encode.encode_bytes`,
      ``csrc/encode_bytes.cu``);
    - ``"codes"`` (the default on the CPU, as the JAX tool serves): one
      int8 code a base, encoded on the host
      (:func:`~..ops.encode.encode_reads_host`);
    - ``"packed"``: DNA on the 2-bit wire
      (:func:`~..ops.encode.pack_reads_2bit`, 3/8 of a byte a base),
      encoded and packed on the host and staged as one pinned buffer, the
      packed bytes then the validity bytes, uploaded by one copy; the
      kernels read it as it is (:class:`~..ops.encode.PackedReads`).

    Every wire gives the same distances.
    """

    def __init__(self, params: ClassifierParams, path: str = "auto", mesh: Layout | None = None,
                 dmat=None, wire: str | None = None):
        self.device = params.twister.device
        if wire is None:  # on the CPU the plain encode is slower than the native host encoder
            wire = "bytes" if self.device.type == "cuda" else "codes"
        if wire not in ("bytes", "codes", "packed"):
            raise ValueError(f"wire must be 'bytes', 'codes' or 'packed', not {wire!r}")
        if wire == "packed" and params.base != 4:
            raise ValueError(f"the 2-bit wire holds DNA, not base {params.base}")
        self.params = params
        self.path = path
        self.mesh = Layout(dp=1, kp=1) if mesh is None else mesh
        self.dmat = dmat
        self.wire = wire
        if wire == "bytes":
            self._ring = ByteRing(pinned=self.device.type != "cpu")
            self._lint = torch.from_numpy(_PROT_CODE if params.base != 4 else _DNA_CODE).to(
                self.device)

    def dispatch(self, seqs: list[str]):
        mesh, on_card, wire = self.mesh, self.device.type != "cpu", self.wire
        with trace.span("serve.dispatch"):
            if wire == "bytes":
                staged, width = self._stage_bytes(seqs)
                sent, shape = staged.buffer, (staged.rows, width)
            else:
                sent, shape = self._stage_codes(seqs)
            if on_card:
                with trace.span("serve.upload"):
                    reads = sent.to(self.device, non_blocking=True)
                    if wire == "bytes":
                        self._ring.uploaded()
            else:
                reads = sent
            if wire == "packed":
                reads = self._packed_reads(reads, *shape)
            with trace.span("serve.launch"):
                if wire == "bytes":
                    reads = encode_bytes(*staged.split(reads), width, self._lint)
                dmat = self._dmat(reads)
            n = len(seqs)
            trace.count("serve.batches")
            trace.count("serve.queries", n)
            trace.count("serve.bases", sum(map(len, seqs)))
            trace.count("serve.upload_bytes", sent.nbytes)
            if self.dmat is None:
                trace.count("serve.route." + self.path)
            self._count_windows(seqs, *shape)
            if not on_card:
                return dmat, None, n, mesh.data_host
            with trace.span("serve.download"):
                host = torch.empty(dmat.shape, dtype=dmat.dtype, pin_memory=True)
                host.copy_(dmat, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            return host, done, n, mesh.data_host

    def _count_windows(self, seqs, rows: int, length: int) -> None:
        """The counters of the count's work, from the host's lengths: this
        rank's windows (``serve.windows``, each sequence's length less k -
        1), its read sets of 2^24 windows or more (``serve.long_rows``),
        and the least bytes of the count (``serve.count_bytes``): the
        ``rows`` rows of codes it reads at their stride (``length`` bases,
        or the 2-bit wire's bytes a row) and the ``[rows, V]`` f32 spectra
        it writes (a shard's rows on a k-mer-sharded rank); 0 on the bag
        route.  ``serve.count_bucketed`` counts the batch where the count
        takes its bucketed plan (:func:`count_plan`)."""
        if not trace.recording():
            return
        k = self.params.k
        b0, b1 = self.mesh.rows(len(seqs) + (-len(seqs)) % self.mesh.dp, "data")
        windows = [max(0, len(s) - k + 1) for s in seqs[b0:b1]]
        trace.count("serve.windows", sum(windows))
        trace.count("serve.long_rows", sum(w >= 1 << 24 for w in windows))
        stride = sum(packed_strides(length)) if self.wire == "packed" else length
        counted = self.dmat is not None or self.path != "bag"
        V = self.params.twister.shape[0]
        trace.count("serve.count_bytes", rows * (stride + 4 * V) if counted else 0)
        trace.count("serve.count_bucketed",
                    int(counted and count_plan(length - k + 1, V).bucket))

    def _pick_path(self, rows: int, length: int) -> None:
        """Pin ``"auto"`` by :func:`pick_path` on the first (full) batch."""
        p = self.params
        if self.dmat is None and self.path == "auto":
            self.path = pick_path(rows, length - p.k + 1, p.n_vocab, p.twister.shape[1])

    def _stage_bytes(self, seqs):
        """This rank's rows of the batch as raw bytes on the ring's next
        buffer, and the codes' width: the batch's longest sequence in
        bytes, at least k."""
        with trace.span("serve.stage"):
            n = len(seqs)
            b0, b1 = self.mesh.rows(n + (-n) % self.mesh.dp, "data")
            staged = self._ring.reserve(seqs, b0, b1)
            width = max(staged.longest, self.params.k)
            self._pick_path(staged.rows, width)
        with trace.span("serve.encode"):
            self._ring.fill(staged)
        return staged, width

    def _stage_codes(self, seqs):
        """This rank's rows of the batch encoded on the host (packed on the
        2-bit wire), pinned where the card takes them, and their shape."""
        p, mesh = self.params, self.mesh
        with trace.span("serve.encode"):
            codes = encode_reads_host(seqs, protein=p.base != 4)
        with trace.span("serve.stage"):
            pad_rows, pad_cols = (-codes.shape[0]) % mesh.dp, max(0, p.k - codes.shape[1])
            if pad_rows or pad_cols:  # -1 pads: a break, counts nothing
                codes = np.pad(codes, ((0, pad_rows), (0, pad_cols)), constant_values=-1)
            b0, b1 = mesh.rows(codes.shape[0], "data")
            codes = np.ascontiguousarray(codes[b0:b1])
            self._pick_path(*codes.shape)
            if self.wire == "packed":
                staged = self._stage_packed(codes)
            else:
                staged = torch.from_numpy(codes)
                if self.device.type != "cpu":
                    staged = staged.pin_memory()
        return staged, codes.shape

    def _stage_packed(self, codes: np.ndarray) -> torch.Tensor:
        """``[B, L]`` int8 codes packed on the host into one buffer (pinned
        where the card takes it), packed bytes then validity bytes, for one
        upload that does not block."""
        B, L = codes.shape
        ps, vs = packed_strides(L)
        staged = torch.empty(B * (ps + vs), dtype=torch.uint8,
                             pin_memory=self.device.type != "cpu")
        packed, valid = pack_reads_2bit(codes)
        host = staged.numpy()
        host[: B * ps] = packed.reshape(-1)
        host[B * ps:] = valid.reshape(-1)
        return staged

    @staticmethod
    def _packed_reads(wire: torch.Tensor, B: int, L: int) -> PackedReads:
        """The read sets on a buffer that :meth:`_stage_packed` laid out."""
        ps, vs = packed_strides(L)
        return PackedReads(wire[: B * ps].view(B, ps), wire[B * ps:].view(B, vs), L)

    def _dmat(self, base_codes) -> torch.Tensor:
        if self.dmat is not None:
            return self.dmat(self.params, base_codes)
        return dmat_step(self.params, base_codes, self.path)

    @staticmethod
    def materialize(handle) -> np.ndarray:
        dmat, done, n, group = handle
        with trace.span("serve.materialize"):
            if done is not None:
                with trace.span("serve.wait"):
                    done.synchronize()
            with trace.span("serve.gather"):
                rows = all_gather_rows(dmat, group)
                dmat = rows[0] if len(rows) == 1 else torch.cat(rows)
                return dmat.numpy().astype(np.float64)[:n]


def layout_kmer_parallel(world: int, kmer_parallel: int, twister_bytes: int) -> int:
    """The ranks that share the twister's rows: 1 on one rank;
    ``kmer_parallel`` (it must divide the rank count, else ParseError), or
    with 0 the least that fits ``KPOP_PARAMS_HBM_BYTES`` a rank (default
    8 GiB, :func:`~..parallel.serving.choose_kmer_parallel`)."""
    from ..parallel.serving import choose_kmer_parallel

    if world == 1:
        return 1
    if kmer_parallel:
        if world % kmer_parallel:
            raise ParseError(
                f"--kmer-parallel {kmer_parallel} does not divide the rank count {world}"
            )
        return kmer_parallel
    budget = int(os.environ.get("KPOP_PARAMS_HBM_BYTES", 8 << 30))
    return choose_kmer_parallel(twister_bytes, world, budget)


def serving_step(space, twister, class_coords, distance, metric, dtype, kmer_parallel: int,
                 project_path: str, verbose: bool = False) -> DeviceStep:
    """The layout choice of ``kpop_tpu/cli/classify.py:277-334`` over the
    process group's ranks, and the step that serves it:
    :func:`layout_kmer_parallel` ranks share the twister's rows
    (:mod:`..parallel.serving`); with 1 the ranks split the batch, the
    parameters replicated (one rank: the whole batch)."""
    from ..parallel.serving import shard_classifier_params, sharded_dmat_fn

    world = distributed.world_size()
    twister_bytes = len(twister.kmer_names) * len(twister.dim_names) * dtype.itemsize
    kp = layout_kmer_parallel(world, kmer_parallel, twister_bytes)
    mesh = make_mesh(world, data_parallel=world // kp)
    if verbose and world > 1 and distributed.is_primary():
        sys.stderr.write(f"(KPopClassify): mesh {mesh.shape} (kmer-parallel {kp})\n")
    if kp == 1:
        params = build_classifier_params(space, twister, class_coords, distance=distance,
                                         metric=metric, device=device(), dtype=dtype)
        return DeviceStep(params, project_path, mesh)
    if project_path == "bag" and distributed.is_primary():
        sys.stderr.write(
            "(KPopClassify): --project-path bag applies to the replicated layout; the "
            "kmer-sharded path counts each rank's rows (parallel/serving.py)\n"
        )
    # the parameters on the host, then only this rank's rows to its card
    host = build_classifier_params(space, twister, class_coords, distance=distance,
                                   metric=metric, device="cpu", dtype=dtype)
    params, v_global = shard_classifier_params(host, mesh, device())
    del host
    return DeviceStep(params, mesh=mesh, dmat=sharded_dmat_fn(mesh, v_global))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    state = {
        "twister": "",
        "targets": "",
        "inputs": [],
        "k": 0,
        "content": "DNA-ds",
        "output": "",
        "batch": 64,
        "keep_at_most": 2,
        "distance": Distance.of_string("euclidean"),
        "metric": Metric.of_string("powers(1,1,2)"),
        "verbose": False,
        "profile": "",
        "dtype": "f32",
        "kmer_parallel": 0,
        "project_path": "auto",
    }
    p = Parser(
        "KPopClassify",
        "-T <twister_prefix> -t <twisted_prefix> -f <fasta> -o <summary_prefix>",
    )
    p.sep("Input/Output")
    p.opt(["-T", "--twister"], "<twister_binary_prefix>",
          ["twister used to project spectra ('.KPopTwister')"],
          lambda a: state.update(twister=a.get()))
    p.opt(["-t", "--targets"], "<twisted_binary_prefix>",
          ["twisted vectors to classify against ('.KPopTwisted')"],
          lambda a: state.update(targets=a.get()))
    p.opt(["-f", "--fasta"], "<fasta_file_name>",
          ["FASTA input (one spectrum per sequence)"],
          lambda a: state["inputs"].append(FastaInput(a.get())))
    p.opt(["-s", "--single-end"], "<fastq_file_name>",
          ["single-end FASTQ input"],
          lambda a: state["inputs"].append(SingleEndFastqInput(a.get())))

    def add_paired(a):
        n1, n2 = a.get(), a.get()
        state["inputs"].append(PairedEndFastqInput(n1, n2))

    p.opt(["-p", "--paired-end"], "<fastq1> <fastq2>",
          ["paired-end FASTQ input (one spectrum per pair batch)"], add_paired)
    p.opt(["-k", "--k-mer-size"], "<k_mer_length>",
          ["k-mer length (must match the twister's k-mer labels)"],
          lambda a: state.update(k=a.get_int_pos()))
    p.opt(["-C", "--content"], "'DNA-ss'|'DNA-ds'|'protein'",
          ["how file contents should be interpreted"],
          lambda a: state.update(content=a.get()), "DNA-ds")
    p.opt(["-o", "--output"], "<summary_file_prefix>",
          ["output summary prefix ('.KPopSummary.txt' unless '/dev/*')"],
          lambda a: state.update(output=a.get()))
    p.sep("Algorithm")
    p.opt(["--batch"], "<positive_integer>",
          ["sequences per device batch"],
          lambda a: state.update(batch=a.get_int_pos()), "64")
    p.opt(["--summary-keep-at-most"], "<positive_integer>",
          ["closest targets kept per query (ties extend the list)"],
          lambda a: state.update(keep_at_most=a.get_int_pos()), "2")
    p.opt(["--distance"], "'euclidean'|'cosine'|'minkowski(p)'",
          ["distance function"],
          lambda a: state.update(distance=Distance.of_string(a.get())),
          "euclidean")
    p.opt(["--metric"], "'flat'|'powers(p,thr,q)'",
          ["metric function"],
          lambda a: state.update(metric=Metric.of_string(a.get())),
          "powers(1,1,2)")

    def set_dtype(a: Args):
        v = a.get()
        if v not in ("f32", "bf16"):
            raise ParseError(f"Invalid dtype '{v}'")
        state["dtype"] = v

    def set_project_path(a: Args):
        v = a.get()
        if v not in ("auto", "dense", "bag"):
            raise ParseError(f"Invalid projection path '{v}'")
        state["project_path"] = v

    p.opt(["--dtype"], "'f32'|'bf16'",
          ["device storage dtype for the twister matrix (bf16 halves the",
           "memory and traffic of the one large tensor; all sums stay f32)"],
          set_dtype, "f32")
    p.opt(["--kmer-parallel"], "<non_negative_integer>",
          ["shard the twister rows over this many ranks (torchrun; no",
           "effect on one rank)"],
          lambda a: state.update(kmer_parallel=a.get_int_non_neg()), "0")
    p.opt(["--project-path"], "'auto'|'dense'|'bag'",
          ["how reads become twisted coordinates: 'dense' counts the",
           "[batch, vocab] spectrum then multiplies by the twister; 'bag'",
           "sums gathered twister rows (the embedding bag) and never",
           "builds spectra; 'auto' picks by estimated memory traffic"],
          set_project_path, "auto")
    p.opt(["--profile"], "<trace_directory>",
          ["write a torch.profiler Chrome trace of the run, with the",
           "serving step's kpop:serve.* ranges, into this directory",
           "(kpop_classify_trace.json), and the step's counters beside",
           "it (kpop_classify_counters.json)"],
          lambda a: state.update(profile=a.get()))
    p.opt(["-v", "--verbose"], None, ["set verbose execution"],
          lambda a: (state.update(verbose=True), set_verbose(True)))
    p.opt(["-V", "--version"], None, ["print version and exit"],
          lambda a: (print(__version__), sys.exit(0)))
    p.opt(["-h", "--help"], None, ["print syntax and exit"],
          lambda a: (p.usage(), sys.exit(0)))
    p.parse(argv)

    if not (state["twister"] and state["targets"] and state["inputs"]):
        raise ParseError("Options '-T', '-t' and an input are mandatory")
    joined = distributed.initialize()  # the torchrun environment, if any
    try:
        return _classify(state)
    finally:
        if joined:
            distributed.shutdown()


def _classify(state: dict) -> int:
    """The tool's work once its options are parsed and the process group,
    if any, joined."""
    world = distributed.world_size()
    if world == 1 and state["kmer_parallel"] > 1 and state["verbose"]:
        sys.stderr.write("(KPopClassify): --kmer-parallel %d has no effect on one device\n"
                         % state["kmer_parallel"])

    twister = Twister.of_binary(state["twister"])
    targets = KPopMatrix.of_binary(MatrixType.TWISTED, state["targets"])
    k = infer_k(
        state["content"], twister.kmer_names, state["k"],
        verbose=state["verbose"],
    )
    space = KmerSpace(state["content"], k)

    # euclidean and cosine share the device path (the reference treats the
    # distance family uniformly, lib/Space.ml:150-205); bounded minkowski
    # stays on the exact host path
    if state["distance"].kind in ("euclidean", "cosine"):
        class_coords = np.asarray(targets.matrix.data, dtype=np.float64)
        dtype = torch.bfloat16 if state["dtype"] == "bf16" else torch.float32
        step = serving_step(space, twister, class_coords, state["distance"], state["metric"],
                            dtype, state["kmer_parallel"], state["project_path"],
                            state["verbose"])
        dispatch_seqs, materialize = step.dispatch, step.materialize
    else:
        from ..core.count import spectrum_of_sequences
        from ..core.matrix import NamedMatrix
        from ..core.space import distance_rowwise

        metric_vec = twister.metrics_vector(state["metric"])
        tmat = NamedMatrix(
            list(targets.matrix.row_names),
            list(targets.matrix.col_names),
            np.asarray(targets.matrix.data, dtype=np.float64),
        )

        def dispatch_seqs(seqs):
            entries = []
            for s in seqs:
                codes, counts = spectrum_of_sequences(space, [s])
                entries.append(
                    [
                        (space.code_to_hex(int(c)), float(v))
                        for c, v in zip(codes, counts)
                    ]
                )
            projected = twister.project_entries(entries)
            qmat = NamedMatrix(
                ["q%d" % i for i in range(len(seqs))],
                list(targets.matrix.col_names),
                projected,
            )
            return distance_rowwise(
                state["distance"], metric_vec, tmat, qmat
            ).data

        def materialize(dmat):
            return dmat

    # rank 0 alone writes the summaries
    out_path = with_ext(state["output"] or "/dev/stdout", SUMMARY_EXT)
    if not distributed.is_primary():
        out_path = os.devnull
    out = open_out(out_path)
    req_len = state["keep_at_most"]
    col_names = targets.matrix.row_names
    n_done = 0
    try:
        batch_tags: list[str] = []
        batch_seqs: list[str] = []
        pending = None  # (tags, handle): ONE batch kept in flight

        def drain():
            """Materialize and write the in-flight batch's summaries."""
            nonlocal n_done, pending
            if pending is None:
                return
            tags, handle = pending
            pending = None
            dmat = materialize(handle)
            with trace.span("serve.format"):
                for tag, row in zip(tags, dmat):
                    out.write(
                        summarize_distance_row(req_len, tag, row, col_names) + "\n"
                    )
            n_done += len(tags)
            if state["verbose"]:
                sys.stderr.write(f"(KPopClassify): {n_done} sequences\r")

        def flush():
            nonlocal pending
            if not batch_tags:
                return
            # dispatch FIRST, then drain the previous batch: summary
            # formatting (and the next batch's parse+encode) overlap the
            # device work of the batch just dispatched
            handle = dispatch_seqs(batch_seqs)
            tags = list(batch_tags)
            batch_tags.clear()
            batch_seqs.clear()
            drain()
            pending = (tags, handle)

        prof = contextlib.nullcontext()
        if state["profile"]:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            trace.reset()
        # segment separator must break k-mer windows: any character outside
        # the alphabet ('N' for DNA; protein uses '*' since N is a residue)
        sep = "N" if state["content"].startswith("DNA") else "*"
        with prof:
            for tag, segments in iter_reads(state["inputs"]):
                batch_tags.append(tag)
                batch_seqs.append(sep.join(segments))
                if len(batch_tags) >= state["batch"]:
                    flush()
            flush()
            drain()
        if state["profile"]:
            os.makedirs(state["profile"], exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(state["profile"], "kpop_classify_trace.json")
            )
            with open(os.path.join(state["profile"], "kpop_classify_counters.json"), "w") as f:
                json.dump(trace.counters(), f, indent=1, sort_keys=True)
    finally:
        close_if_owned(out, out_path)
    if state["verbose"]:
        sys.stderr.write(f"(KPopClassify): {n_done} sequences done.\n")
    return 0


if __name__ == "__main__":
    from ..utils.cli import run

    sys.exit(run(main))
