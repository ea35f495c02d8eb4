"""``kpop-twist-torch``: ``kpop-twist`` with its device CA on the PyTorch
port.

The counterpart of ``kpop_tpu/cli/twist.py``: the same options and output
(``.KPopTwister`` + ``.KPopTwisted`` binaries, and ``.KPopTwisted`` k-mer
coordinates with ``-K``).  ``--backend jax`` (the default) trains on the
device that ``KPOP_PLATFORM`` names
(:func:`kpop_tpu_torch.parallel.sharded.ca_fit_sharded`: the compact wire
upload, the fused residual-Gram kernel, host float64 ``eigh``), and raises
without a card unless ``KPOP_PLATFORM=cpu``; ``--backend host`` is the
float64 host CA of the JAX tool.
"""

from __future__ import annotations

import sys

from .. import __version__
from ..core.counter_db import CounterDB
from ..core.transforms import Transformation
from ..core.twister import TwistParameters, twist_counter_db
from ..utils.cli import ParseError, Parser
from ..utils.progress import set_verbose


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    state = {
        "input": "",
        "output": "",
        "output_kmers": "",
        "kmers_keep": "",
        "kmers_sample": 1.0,
        "threshold_counts": 1.0,
        "power": 1.0,
        "transform": "power",
        "normalize": True,
        "threshold_kmers": 0.0,
        "seed": None,
        "verbose": False,
        "backend": "jax",
        "n_dims": None,
    }
    p = Parser(
        "KPopTwist",
        "-i|--input <binary_input_prefix> -o|--output <binary_output_prefix> [OPTIONS]",
    )
    p.sep("Algorithmic parameters")
    p.opt(["-k", "--kmers", "--keep", "--keep-kmers", "--kmers-keep"],
          "<kmer_list_file>",
          ["discard k-mers not listed in this file before twisting",
           "(one k-mer label per line, no header)"],
          lambda a: state.update(kmers_keep=a.get()), "keep all")
    p.opt(["-s", "--sample", "--sample-kmers", "--kmers-sample"],
          "<fractional_float>",
          ["fraction of k-mers randomly resampled and kept"],
          lambda a: state.update(kmers_sample=a.get_float_fraction()), "1.")
    p.opt(["--counts-threshold"], "<non_negative_float>",
          ["zero all counts below this threshold before transforming"],
          lambda a: state.update(threshold_counts=a.get_float_non_neg()), "1.")
    p.opt(["--counts-power"], "<non_negative_float>",
          ["raise counts to this power before transforming"],
          lambda a: state.update(power=a.get_float_non_neg()), "1.")
    p.opt(["--counts-transform", "--counts-transformation"],
          "'binary'|'power'|'pseudocounts'|'clr'",
          ["transformation to apply to table elements"],
          lambda a: state.update(transform=a.get()), "power")
    p.opt(["--counts-normalize", "--counts-normalization"], "'true'|'false'",
          ["whether to normalize spectra after transformation, before twisting"],
          lambda a: state.update(normalize=a.get_bool()), "true")
    p.opt(["--kmers-threshold"], "<non_negative_float>",
          ["eliminate k-mers whose total count is below the largest total",
           "rescaled by this threshold"],
          lambda a: state.update(threshold_kmers=a.get_float_non_neg()), "0.")
    p.opt(["--seed"], "<integer>",
          ["RNG seed for k-mer resampling (kpop-tpu extension)"],
          lambda a: state.update(seed=int(a.get())))
    p.opt(["--backend"], "'host'|'jax'",
          ["CA backend: 'jax', the default: the fused residual-Gram kernel on",
           "the card; or 'host': float64 host numpy (kpop-tpu extension)"],
          lambda a: state.update(backend=a.get()), "jax")
    p.opt(["--dims", "--n-dims"], "<positive_integer>",
          ["keep only this many leading CA dimensions (kpop-tpu",
           "extension; the single-chip mode for flagship vocabularies,",
           "where the full-dim twister exceeds one device's HBM —",
           "inertia stays normalized over the full spectrum)"],
          lambda a: state.update(n_dims=a.get_int_pos()), "all")
    p.sep("Input/Output")
    p.opt(["-i", "--input"], "<binary_file_prefix>",
          ["k-mer database to twist ('.KPopCounter' unless '/dev/*')"],
          lambda a: state.update(input=a.get()))
    p.opt(["-o", "--output"], "<binary_file_prefix>",
          ["prefix for generated twister and twisted sequences",
           "('.KPopTwister' and '.KPopTwisted' unless '/dev/*')"],
          lambda a: state.update(output=a.get()))
    p.opt(["-K", "--output-kmers", "--output-twisted-kmers"],
          "<binary_file_prefix>",
          ["prefix for twisted k-mer coordinates ('.KPopTwisted')"],
          lambda a: state.update(output_kmers=a.get()), "do not output")
    p.sep("Miscellaneous")
    p.opt(["-T", "--threads"], "<computing_threads>",
          ["advisory; PyTorch/BLAS decide"], lambda a: a.get_int_pos())
    p.opt(["--keep-temporaries"], None,
          ["compatibility no-op (no temporaries are produced)"], lambda a: None)
    p.opt(["-v", "--verbose"], None, ["set verbose execution"],
          lambda a: (state.update(verbose=True), set_verbose(True)))
    p.opt(["-V", "--version"], None, ["print version and exit"],
          lambda a: (print(__version__), sys.exit(0)))
    p.opt(["-h", "--help"], None, ["print syntax and exit"],
          lambda a: (p.usage(), sys.exit(0)))
    p.parse(argv)

    if not state["input"] or not state["output"]:
        raise ParseError("Options '-i' and '-o' are mandatory")

    db = CounterDB.of_binary(state["input"])
    keep = None
    if state["kmers_keep"]:
        with open(state["kmers_keep"]) as f:
            keep = [ln.strip() for ln in f if ln.strip()]
    params = TwistParameters(
        kmers_keep=keep,
        kmers_sample=state["kmers_sample"],
        transform=Transformation(
            state["transform"], state["threshold_counts"], state["power"]
        ),
        normalize=state["normalize"],
        threshold_kmers=state["threshold_kmers"],
        seed=state["seed"],
        n_dims=state["n_dims"],
    )
    twister, twisted, twisted_kmers = twist_counter_db(
        db, params, backend=state["backend"], verbose=state["verbose"]
    )
    twister.to_binary(state["output"])
    twisted.to_binary(state["output"])
    if state["output_kmers"]:
        twisted_kmers.to_binary(state["output_kmers"])
    if state["verbose"]:
        sys.stderr.write(
            f"(KPopTwist): {db.n_rows} k-mers x {db.n_cols} spectra -> "
            f"{len(twister.dim_names)} dimensions.\n"
        )
    return 0


if __name__ == "__main__":
    from ..utils.cli import run

    sys.exit(run(main))
