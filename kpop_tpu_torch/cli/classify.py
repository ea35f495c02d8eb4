"""``kpop-classify-torch``: one-shot FASTA/FASTQ -> distance summaries, with
the device step in PyTorch.

The counterpart of ``kpop_tpu/cli/classify.py``: the same options and the
same ``.KPopSummary.txt`` output.  Distances are computed on the device in
float32 (:mod:`kpop_tpu_torch.ops.pipeline`) and the summary statistics on
the host in float64 over each full distance row
(``kpop_tpu/core/space.py::summarize_distance_row``).  The device is the
one ``KPOP_PLATFORM`` names (:func:`kpop_tpu_torch.config.device`).
Minkowski distances take the exact host path, as in the JAX tool.

Not ported yet (they raise): ``--dtype bf16`` and ``--kmer-parallel``
above 1.
"""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import torch

from ..core.kmers import KmerSpace
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

from .. import __version__
from ..config import device
from ..ops.encode import encode_reads_host
from ..ops.pipeline import (
    ROADMAP_NOTE,
    ClassifierParams,
    build_classifier_params,
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


def dmat_step(params: ClassifierParams, base_codes: torch.Tensor, path: str):
    """``[B, L]`` base codes -> ``[B, C]`` distances to the classes, through
    the dense route (count, then the twister product) or the bag."""
    if path == "bag":
        twisted = project_reads(params, base_codes)
    else:
        twisted = project(params, count_spectra(params, base_codes))
    return distances_to_classes(params, twisted)


class DeviceStep:
    """Encode a batch on the host, upload it, run :func:`dmat_step` and
    start the download, without waiting.

    On a card the result is copied without blocking into pinned host memory
    and an event is recorded behind it; :meth:`materialize` waits on that
    event alone.  ``tensor.cpu()`` would also wait for any batch dispatched
    after this one, and the serve loop keeps one batch in flight so that the
    host formats one batch while the card computes the next.
    """

    def __init__(self, params: ClassifierParams, path: str = "auto"):
        self.params = params
        self.path = path
        self.device = params.twister.device

    def dispatch(self, seqs: list[str]):
        p = self.params
        codes = encode_reads_host(seqs, protein=p.base != 4)
        n = codes.shape[0]
        if codes.shape[1] < p.k:  # -1 pads: a break, counts nothing
            codes = np.pad(
                codes, ((0, 0), (0, p.k - codes.shape[1])), constant_values=-1
            )
        if self.path == "auto":  # pinned on the first (full) batch
            self.path = pick_path(
                n, codes.shape[1] - p.k + 1, p.n_vocab, p.twister.shape[1]
            )
        base_codes = torch.from_numpy(codes)
        if self.device.type == "cpu":
            return dmat_step(p, base_codes, self.path), None, n
        base_codes = base_codes.pin_memory().to(self.device, non_blocking=True)
        dmat = dmat_step(p, base_codes, self.path)
        host = torch.empty(dmat.shape, dtype=dmat.dtype, pin_memory=True)
        host.copy_(dmat, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done, n

    @staticmethod
    def materialize(handle) -> np.ndarray:
        dmat, done, n = handle
        if done is not None:
            done.synchronize()
        return dmat.numpy().astype(np.float64)[:n]


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
          ["device storage dtype for the twister matrix (only f32 in",
           "the PyTorch port so far)"],
          set_dtype, "f32")
    p.opt(["--kmer-parallel"], "<non_negative_integer>",
          ["shard the twister rows over this many devices (only 0 or 1,",
           "one device, in the PyTorch port so far)"],
          lambda a: state.update(kmer_parallel=a.get_int_non_neg()), "0")
    p.opt(["--project-path"], "'auto'|'dense'|'bag'",
          ["how reads become twisted coordinates: 'dense' counts the",
           "[batch, vocab] spectrum then multiplies by the twister; 'bag'",
           "sums gathered twister rows (the embedding bag) and never",
           "builds spectra; 'auto' picks by estimated memory traffic"],
          set_project_path, "auto")
    p.opt(["--profile"], "<trace_directory>",
          ["write a torch.profiler Chrome trace of the run into this",
           "directory (kpop_classify_trace.json)"],
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
    if state["dtype"] == "bf16":
        raise ParseError(f"Option '--dtype bf16' is {ROADMAP_NOTE}")
    if state["kmer_parallel"] > 1:
        raise ParseError(f"Option '--kmer-parallel' above 1 is {ROADMAP_NOTE}")

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
        params = build_classifier_params(
            space,
            twister,
            np.asarray(targets.matrix.data, dtype=np.float64),
            distance=state["distance"],
            metric=state["metric"],
            device=device(),
        )
        step = DeviceStep(params, state["project_path"])
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

    out_path = with_ext(state["output"] or "/dev/stdout", SUMMARY_EXT)
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
    finally:
        close_if_owned(out, out_path)
    if state["verbose"]:
        sys.stderr.write(f"(KPopClassify): {n_done} sequences done.\n")
    return 0


if __name__ == "__main__":
    from ..utils.cli import run

    sys.exit(run(main))
