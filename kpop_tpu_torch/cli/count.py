"""``kpop-count-torch``: extract k-mer spectra from FASTA/FASTQ inputs.

CLI-compatible with the reference's ``KPopCount`` (bin/KPopCount.ml:105-250).
A copy of ``kpop_tpu/cli/count.py``, which counts on the host
(:mod:`kpop_tpu_torch.core.count`, the native counter): the port counts,
trains and serves any k without a JAX tool.  It writes the same bytes as
``kpop-count``.
"""

from __future__ import annotations

import sys

from .. import __version__
from ..core.count import DEFAULT_MAX_RESULTS_SIZE, count_reads
from ..core.kmers import KmerSpace
from ..io.reads import FastaInput, PairedEndFastqInput, SingleEndFastqInput
from ..io.spectra import spectra_filename
from ..utils.cli import Args, ParseError, Parser
from ..utils.progress import set_verbose
from ..utils.naming import close_if_owned, open_out
from ..utils.quoting import QuotesInName, strip_external_quotes_and_check

CONTENTS = {
    "DNA-ss": "DNA-ss",
    "DNA-single-stranded": "DNA-ss",
    "DNA-ds": "DNA-ds",
    "DNA-double-stranded": "DNA-ds",
    "protein": "protein",
    "prot": "protein",
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    state = {
        "k": 12,
        "max_results_size": DEFAULT_MAX_RESULTS_SIZE,
        "content": "DNA-ds",
        "inputs": [],
        "label": "",
        "l_or_L": False,
        "output": "",
        "verbose": False,
        "threads": None,
    }
    p = Parser("KPopCount", "-l <output_vector_label>|-L [OPTIONS]")
    p.sep("Algorithmic parameters")
    p.opt(
        ["-k", "-K", "--k-mer-size", "--k-mer-length"],
        "<k_mer_length>",
        ["k-mer length", "(must be positive, and <= 30 for DNA or <= 12 for protein)"],
        lambda a: state.update(k=a.get_int_pos()),
        "12",
    )
    p.opt(
        ["-M", "--max-results-size"],
        "<positive_integer>",
        ["maximum number of k-mer hashes to be kept in memory at any given time"],
        lambda a: state.update(max_results_size=a.get_int_pos()),
        str(DEFAULT_MAX_RESULTS_SIZE),
    )
    p.sep("Input/Output")

    def set_content(a: Args):
        v = a.get()
        if v not in CONTENTS:
            raise ParseError(f"Invalid content '{v}'")
        state["content"] = CONTENTS[v]

    p.opt(
        ["-C", "--content"],
        "'DNA-ss'|'DNA-ds'|'protein'",
        ["how file contents should be interpreted"],
        set_content,
        "DNA-ds",
    )
    p.opt(
        ["-f", "--fasta"],
        "<fasta_file_name>",
        ["FASTA input file containing sequences"],
        lambda a: state["inputs"].append(FastaInput(a.get())),
    )
    p.opt(
        ["-s", "--single-end"],
        "<fastq_file_name>",
        ["FASTQ input file containing single-end sequencing reads"],
        lambda a: state["inputs"].append(SingleEndFastqInput(a.get())),
    )

    def add_paired(a: Args):
        n1 = a.get()
        n2 = a.get()
        state["inputs"].append(PairedEndFastqInput(n1, n2))

    p.opt(
        ["-p", "--paired-end"],
        "<fastq_file_name1> <fastq_file_name2>",
        ["FASTQ input files containing paired-end sequencing reads"],
        add_paired,
    )

    def set_label(a: Args):
        try:
            state["label"] = strip_external_quotes_and_check(a.get())
        except QuotesInName:
            raise ParseError("Spectrum labels must not contain quotes") from None
        state["l_or_L"] = True

    p.opt(
        ["-l", "--label"],
        "<output_vector_label>",
        ["label to be given to the k-mer spectrum in the output file"],
        set_label,
    )
    p.opt(
        ["-L", "--one-spectrum-per-sequence"],
        None,
        ["output one spectrum per input sequence, using the sequence name as label"],
        lambda a: state.update(l_or_L=True),
    )
    p.opt(
        ["-o", "--output"],
        "<output_file_prefix>",
        ["prefix of the generated output file",
         " (extension '.KPopSpectra.txt' unless file is '/dev/*')"],
        lambda a: state.update(output=spectra_filename(a.get())),
        "<stdout>",
    )
    p.sep("Miscellaneous")
    # The reference declares (but comments out) -t/-T for KPopCount
    # (bin/KPopCount.ml:188-194); here it controls the native batch
    # counter's thread count (default 1: the serial hash merge bounds the
    # win at low k-mer duplication — opt in on many-core hosts).
    p.opt(["-t", "-T", "--threads"], "<computing_threads>",
          ["number of concurrent computing threads for -l batch counting"],
          lambda a: state.update(threads=a.get_int_pos()),
          "1")
    p.opt(["-v", "--verbose"], None, ["set verbose execution"],
          lambda a: (state.update(verbose=True), set_verbose(True)))
    p.opt(["-V", "--version"], None, ["print version and exit"],
          lambda a: (print(__version__), sys.exit(0)))
    p.opt(["-h", "--help"], None, ["print syntax and exit"],
          lambda a: (p.usage(), sys.exit(1)))
    p.parse(argv)

    if not state["l_or_L"]:
        raise ParseError("One of options '-l' and '-L' is mandatory")
    mixed = {type(i) for i in state["inputs"]}
    if FastaInput in mixed and len(mixed) > 1:
        raise ParseError("You cannot process FASTA and FASTQ inputs together")
    if not state["inputs"]:
        return 0
    space = KmerSpace(state["content"], state["k"])
    path = state["output"] if state["output"] else "/dev/stdout"
    out = open_out(path)
    try:
        n = count_reads(
            state["inputs"],
            space,
            out,
            label=state["label"],
            max_results_size=state["max_results_size"],
            threads=state["threads"],
        )
    finally:
        close_if_owned(out, path)
    if state["verbose"]:
        sys.stderr.write(f"(KPopCount): Added {n} reads.\n")
    return 0


if __name__ == "__main__":
    from ..utils.cli import run

    sys.exit(run(main))
