"""``kpop-countdb-torch``: ``kpop-countdb`` with its device backend on the
PyTorch port.

The counterpart of ``kpop_tpu/cli/countdb.py``: the same options, actions
and output.  Only the ``--backend`` branch of ``--distances`` differs: for
euclidean and cosine distances it runs
:func:`kpop_tpu_torch.ops.summaries.distance_rowwise_device` on the device
that ``KPOP_PLATFORM`` names (``pallas``: the hand distance tile for
euclidean; ``jax``, ``tpu`` and ``device``: the matrix-product route).
Minkowski distances, and the default ``host``, take the float64 host path.
"""

from __future__ import annotations

import sys
from dataclasses import replace as dc_replace

from ..core.counter_db import CounterDB, TableFilter
from ..core.matrix import KPopMatrix, MatrixType
from ..core.space import Distance, distance_rowwise
from ..core.transforms import Transformation
from ..utils.cli import Args, Parser, parse_regexp_selector
from ..utils.progress import set_verbose

from .. import __version__
from .twistdb import DEVICE_BACKENDS


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    program = []  # delayed actions
    settings = {"verbose": False, "threads": 0}

    def act(fn):
        program.append(fn)

    p = Parser("KPopCountDB", "[ACTIONS]")
    p.sep("Actions.", "They are executed delayed and in order of specification.")
    p.sep("", "Actions on the database register:")
    p.opt(["-e", "--empty"], None, ["put an empty database into the register"],
          lambda a: act(lambda st: st.update(db=CounterDB())))
    p.opt(
        ["-i", "--input"],
        "<binary_file_prefix>",
        ["load into the register the database present in the specified file",
         " (extension '.KPopCounter' unless file is '/dev/*')"],
        lambda a: (lambda prefix: act(
            lambda st: st.update(db=CounterDB.of_binary(prefix))
        ))(a.get()),
    )
    p.opt(
        ["-m", "--metadata", "--add-metadata"],
        "<metadata_table_file_name>",
        ["add metadata from the specified tab-separated file"],
        lambda a: (lambda fname: act(lambda st: st["db"].add_meta(fname)))(a.get()),
    )
    p.opt(
        ["-k", "--kmers", "--add-kmers", "--add-kmer-files"],
        "<k-mer_table_file_prefix>[,...]",
        ["add k-mer spectra from the specified files",
         " (extension '.KPopSpectra.txt' unless file is '/dev/*')"],
        lambda a: (lambda prefixes: act(
            lambda st: st["db"].add_files(prefixes)
        ))(a.get().split(",")),
    )
    p.opt(
        ["--combination-criterion", "--spectrum-combination-criterion"],
        "'mean'|'median'",
        ["criterion used to combine the k-mer frequencies of spectra"],
        lambda a: (lambda c: act(lambda st: st.update(criterion=c)))(a.get()),
        "mean",
    )
    p.opt(
        ["-c", "--combine", "--combine-by-class", "--combine-spectra-by-class"],
        "<classes_metadata_field_name>",
        ["split the table into classes and combine the spectra of each class",
         "into a vector named as the class label; delete original spectra"],
        lambda a: (lambda lbl: act(
            lambda st: st.update(db=st["db"].split_spectra(lbl, st["criterion"]))
        ))(a.get()),
    )

    def add_distill(a: Args):
        classes_label = a.get()
        prefix = a.get()
        act(lambda st: st["db"].distill_to_file(classes_label, prefix))

    p.opt(
        ["-d", "--distill", "--distill-kmers"],
        "<classes_metadata_field_name> <summary_file_prefix>",
        ["identify most informative k-mers per class",
         " (output gets extension '.KPopDistill.txt' unless '/dev/*')"],
        add_distill,
    )
    p.opt(
        ["--summary"], None,
        ["print a summary of the database present in the register"],
        lambda a: act(lambda st: sys.stderr.write(
            "\n".join(st["db"].summary_lines(settings["verbose"])) + "\n"
        )),
    )
    p.opt(
        ["-o", "--output"],
        "<binary_file_prefix>",
        ["save the database to the specified file",
         " (extension '.KPopCounter' unless file is '/dev/*')"],
        lambda a: (lambda prefix: act(lambda st: st["db"].to_binary(prefix)))(a.get()),
    )
    p.opt(
        ["--distance", "--distance-function"],
        "'euclidean'|'minkowski(<non_negative_float>)'",
        ["function used when computing distances"],
        lambda a: (lambda d: act(lambda st: st.update(distance=d)))(
            Distance.of_string(a.get())
        ),
        "euclidean",
    )
    p.opt(
        ["--distance-normalize", "--distance-normalization"],
        "'true'|'false'",
        ["whether spectra should be normalized prior to computing distances"],
        lambda a: (lambda b: act(lambda st: st.update(distance_normalize=b)))(
            a.get_bool()
        ),
    )
    p.opt(
        ["--backend"],
        "'host'|'jax'|'pallas'",
        ["compute backend for --distances: float64 host numpy (exact,",
         "default), float32 matrix product on the PyTorch device ('jax';",
         "'tpu' and 'device' are aliases), or the hand CUDA distance tile",
         "('pallas', euclidean)"],
        lambda a: (lambda v: act(lambda st: st.update(backend=v)))(a.get()),
        "host",
    )

    def add_to_distances(a: Args):
        r1 = parse_regexp_selector(a.current_opt, a.get())
        r2 = parse_regexp_selector(a.current_opt, a.get())
        prefix = a.get()

        def run(st):
            import numpy as np

            db: CounterDB = st["db"]
            s1 = db.selected_from_regexps(r1)
            s2 = db.selected_from_regexps(r2)
            m1 = db.submatrix_normalized(s1, st["distance_normalize"])
            m2 = db.submatrix_normalized(s2, st["distance_normalize"])
            metric = np.ones(db.n_rows)
            if st["backend"] in DEVICE_BACKENDS and st["distance"].kind in (
                "euclidean", "cosine"
            ):
                # device path for the huge raw-spectrum dimension
                # ('pallas' routes euclidean blocks through the distance tile)
                from ..ops.summaries import distance_rowwise_device

                dm = distance_rowwise_device(
                    st["distance"],
                    metric,
                    m1,
                    m2,
                    normalize=True,
                    backend=st["backend"],
                )
            else:
                dm = distance_rowwise(
                    st["distance"], metric, m1, m2, normalize=True
                )
            KPopMatrix(MatrixType.DMATRIX, dm).to_binary(prefix)

        act(run)

    p.opt(
        ["--distances", "--compute-distances", "--compute-spectral-distances"],
        "REGEXP_SELECTOR REGEXP_SELECTOR <binary_file_prefix>",
        ["select two sets of spectra and compute all-pairs distances",
         " (result gets extension '.KPopDMatrix' unless '/dev/*')"],
        add_to_distances,
    )

    def filt_update(**kw):
        def run(st):
            st["filter"] = dc_replace(st["filter"], **kw)

        return run

    p.opt(["--table-output-row-names"], "'true'|'false'",
          ["whether to output row names when writing tables"],
          lambda a: (lambda b: act(filt_update(print_row_names=b)))(a.get_bool()),
          "true")
    p.opt(["--table-output-col-names"], "'true'|'false'",
          ["whether to output column names when writing tables"],
          lambda a: (lambda b: act(filt_update(print_col_names=b)))(a.get_bool()),
          "true")
    p.opt(["--table-output-metadata"], "'true'|'false'",
          ["whether to output metadata when writing tables"],
          lambda a: (lambda b: act(filt_update(print_metadata=b)))(a.get_bool()),
          "false")
    p.opt(["--table-transpose"], "'true'|'false'",
          ["whether to transpose the table before writing it"],
          lambda a: (lambda b: act(filt_update(transpose=b)))(a.get_bool()),
          "false")

    def transform_update(**kw):
        def run(st):
            st["transform"] = dc_replace(st["transform"], **kw)
            st["filter"] = dc_replace(st["filter"], transform=st["transform"])

        return run

    p.opt(["--counts-threshold"], "<non_negative_integer>",
          ["set to zero all counts below this threshold before transforming;",
           "a fractional threshold is relative to the sum of spectrum counts"],
          lambda a: (lambda v: act(transform_update(threshold=v)))(
              a.get_float_non_neg()),
          "1.")
    p.opt(["--counts-power"], "<non_negative_float>",
          ["raise counts to this power before transforming"],
          lambda a: (lambda v: act(transform_update(power=v)))(
              a.get_float_non_neg()),
          "1.")
    p.opt(["--counts-transform", "--counts-transformation"],
          "'binary'|'power'|'pseudocounts'|'clr'",
          ["transformation to apply to counts on output"],
          lambda a: (lambda v: act(transform_update(which=v)))(a.get()),
          "power")
    p.opt(["--counts-output-zero-kmers", "--counts-output-zero-k-mers"],
          "'true'|'false'",
          ["whether to output k-mers whose frequencies are all zero"],
          lambda a: (lambda b: act(filt_update(print_zero_rows=b)))(a.get_bool()),
          "false")
    p.opt(["--counts-precision"], "<positive_integer>",
          ["number of precision digits used when outputting counts"],
          lambda a: (lambda v: act(filt_update(precision=v)))(a.get_int_pos()),
          "15")
    p.opt(
        ["-t", "--table", "--to-table"],
        "<file_prefix>",
        ["write the database as a tab-separated file",
         " (extension '.KPopCounter.txt' unless file is '/dev/*')"],
        lambda a: (lambda prefix: act(
            lambda st: st["db"].to_table(prefix, st["filter"])
        ))(a.get()),
    )
    p.opt(
        ["-s", "--spectra", "--to-spectra"],
        "<file_prefix>",
        ["write the database as k-mer spectra",
         " (extension '.KPopSpectra.txt' unless file is '/dev/*')"],
        lambda a: (lambda prefix: act(
            lambda st: st["db"].to_spectra(prefix, st["filter"])
        ))(a.get()),
    )
    p.sep("", "Actions involving the selection register:")
    p.opt(
        ["-L", "--labels", "--selection-from-labels"],
        "<spectrum_label>[,...]",
        ["put into the selection register the specified labels"],
        lambda a: (lambda labels: act(
            lambda st: st.update(selected=set(labels))
        ))(a.get().split(",")),
    )
    p.opt(
        ["-R", "--regexps", "--selection-from-regexps"],
        "<metadata_field>'~'<regexp>[,...]",
        ["put into the selection register the labels of the spectra",
         "whose metadata fields match the specified regexps (Python re",
         "syntax, matched at the start); an empty field matches labels"],
        lambda a: (lambda rs: act(
            lambda st: st.update(selected=st["db"].selected_from_regexps(rs))
        ))(parse_regexp_selector(a.current_opt, a.get())),
    )
    p.opt(
        ["-A", "--add-combined-selection", "--selection-combine-and-add"],
        "<spectrum_label>",
        ["combine spectra whose labels are in the selection register and",
         "add/replace the result in the database register"],
        lambda a: (lambda lbl: act(
            lambda st: st["db"].add_combined_selected(
                lbl, st["selected"], st["criterion"]
            )
        ))(a.get()),
    )
    p.opt(
        ["-D", "--delete", "--selection-delete"],
        None,
        ["drop selected spectra from the database register"],
        lambda a: act(lambda st: st.update(db=st["db"].remove_selected(st["selected"]))),
    )
    p.opt(
        ["-N", "--selection-negate"], None,
        ["negate the labels present in the selection register"],
        lambda a: act(lambda st: st.update(
            selected=st["db"].selected_negate(st["selected"])
        )),
    )
    p.opt(
        ["-P", "--selection-print"], None,
        ["print the labels present in the selection register"],
        lambda a: act(lambda st: sys.stderr.write(
            "Currently selected spectra = [%s ].\n"
            % "".join(" '%s'" % s for s in sorted(st["selected"]))
        )),
    )
    p.opt(["-C", "--selection-clear"], None, ["purge the selection register"],
          lambda a: act(lambda st: st.update(selected=set())))
    p.opt(
        ["-F", "--selection-to-table-filter"], None,
        ["filter out selected spectra when writing tables"],
        lambda a: act(lambda st: st.update(
            filter=dc_replace(st["filter"], filter_columns=frozenset(st["selected"]))
        )),
    )
    p.sep("Miscellaneous options.", "They are set immediately")
    p.opt(["-T", "--threads"], "<computing_threads>",
          ["number of concurrent computing threads (advisory; XLA/BLAS decide)"],
          lambda a: settings.update(threads=a.get_int_pos()))
    p.opt(["-v", "--verbose"], None, ["set verbose execution"],
          lambda a: (settings.update(verbose=True), set_verbose(True)))
    p.opt(["-V", "--version"], None, ["print version and exit"],
          lambda a: (print(__version__), sys.exit(0)))
    p.opt(["-h", "--help"], None, ["print syntax and exit"],
          lambda a: (p.usage(), sys.exit(0)))
    p.parse(argv)

    if not program:
        p.usage()
        return 0

    class State(dict):
        pass

    st = State(
        db=CounterDB(),
        selected=set(),
        criterion="mean",
        transform=Transformation(),
        filter=TableFilter(),
        distance=Distance.of_string("euclidean"),
        distance_normalize=True,
        backend="host",
    )
    for fn in program:
        fn(st)
    return 0


if __name__ == "__main__":
    from ..utils.cli import run

    sys.exit(run(main))
