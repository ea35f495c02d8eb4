"""Declarative action-program CLI framework.

Re-provides the capability of BiOCamLib's ``Tools.Argv`` (consumed by every
reference binary, e.g. bin/KPopCount.ml:106-212): options are declared with
aliases, argument documentation and help lines; *action* options accumulate
into a delayed program that the tool interprets in order of specification
(README.md:262-268), while *setting* options take effect immediately.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence


class ParseError(SystemExit):
    pass


@dataclass
class Opt:
    aliases: List[str]
    arg_doc: Optional[str]
    help_lines: List[str]
    handler: Callable[["Args"], None]
    default_doc: Optional[str] = None


@dataclass
class Separator:
    lines: List[str]


@dataclass
class Args:
    """Cursor over argv giving typed parameter getters (Tools.Argv style)."""

    argv: List[str]
    pos: int = 0
    current_opt: str = ""

    def _next(self) -> str:
        if self.pos >= len(self.argv):
            raise ParseError(
                f"Option '{self.current_opt}': missing parameter"
            )
        v = self.argv[self.pos]
        self.pos += 1
        return v

    def get(self) -> str:
        return self._next()

    def _next_int(self) -> int:
        raw = self._next()
        try:
            return int(raw)
        except ValueError:
            raise ParseError(
                f"Option '{self.current_opt}': expected an integer, "
                f"found '{raw}'"
            ) from None

    def _next_float(self) -> float:
        raw = self._next()
        try:
            return float(raw)
        except ValueError:
            raise ParseError(
                f"Option '{self.current_opt}': expected a number, "
                f"found '{raw}'"
            ) from None

    def get_int(self) -> int:
        return self._next_int()

    def get_int_pos(self) -> int:
        v = self._next_int()
        if v <= 0:
            raise ParseError(
                f"Option '{self.current_opt}': parameter must be positive"
            )
        return v

    def get_int_non_neg(self) -> int:
        v = self._next_int()
        if v < 0:
            raise ParseError(
                f"Option '{self.current_opt}': parameter must be non-negative"
            )
        return v

    def get_float_non_neg(self) -> float:
        v = self._next_float()
        if v < 0.0:
            raise ParseError(
                f"Option '{self.current_opt}': parameter must be non-negative"
            )
        return v

    def get_float_fraction(self) -> float:
        v = self._next_float()
        if not (0.0 <= v <= 1.0):
            raise ParseError(
                f"Option '{self.current_opt}': parameter must be in [0,1]"
            )
        return v

    def get_bool(self) -> bool:
        v = self._next()
        if v in ("true", "True"):
            return True
        if v in ("false", "False"):
            return False
        raise ParseError(
            f"Option '{self.current_opt}': expected 'true'|'false', found '{v}'"
        )


@dataclass
class Parser:
    name: str
    synopsis: str
    specs: List[Opt | Separator] = field(default_factory=list)

    def sep(self, *lines: str) -> None:
        self.specs.append(Separator(list(lines)))

    def opt(
        self,
        aliases: Sequence[str],
        arg_doc: Optional[str],
        help_lines: Sequence[str],
        handler: Callable[[Args], None],
        default_doc: Optional[str] = None,
    ) -> None:
        self.specs.append(
            Opt(list(aliases), arg_doc, list(help_lines), handler, default_doc)
        )

    def usage(self, out=sys.stderr) -> None:
        out.write(f"Usage: {self.name} {self.synopsis}\n")
        for spec in self.specs:
            if isinstance(spec, Separator):
                for ln in spec.lines:
                    out.write(f"\n{ln}\n" if ln else "\n")
            else:
                out.write("  " + "|".join(spec.aliases))
                if spec.arg_doc:
                    out.write(" " + spec.arg_doc)
                out.write("\n")
                for ln in spec.help_lines:
                    out.write("    " + ln + "\n")
                if spec.default_doc:
                    out.write(f"    (default: {spec.default_doc})\n")

    def parse(self, argv: Sequence[str]) -> None:
        table = {}
        for spec in self.specs:
            if isinstance(spec, Opt):
                for a in spec.aliases:
                    table[a] = spec
        args = Args(list(argv))
        while args.pos < len(args.argv):
            opt_name = args.argv[args.pos]
            args.pos += 1
            if opt_name == "--markdown":  # hidden help exporter
                sys.stdout.write(markdown_help(self))
                raise SystemExit(0)
            spec = table.get(opt_name)
            if spec is None:
                self.usage()
                raise ParseError(f"Unknown option '{opt_name}'")
            args.current_opt = opt_name
            spec.handler(args)


def run(main, argv=None) -> int:
    """Top-level CLI runner with the reference's error UX
    (bin/KPopCountDB.ml:439-444): uncaught exceptions print a FATAL line;
    the hidden ``-x``/``--print-exception-backtrace`` option re-raises with
    a full traceback."""
    argv = list(sys.argv[1:] if argv is None else argv)
    backtrace = False
    for flag in ("-x", "--print-exception-backtrace"):
        while flag in argv:
            argv.remove(flag)
            backtrace = True
    try:
        return main(argv)
    except SystemExit:
        raise
    except Exception as exc:
        if backtrace:
            raise
        sys.stderr.write(
            "FATAL: Uncaught exception: %s: %s\n"
            % (type(exc).__name__, exc)
        )
        sys.stderr.write(
            "Rerun with option -x to get a full backtrace.\n"
        )
        return 1


def markdown_help(parser: "Parser") -> str:
    """Markdown rendering of the option table (the reference's hidden
    ``--markdown`` exporter, e.g. bin/KPopCount.ml:206)."""
    out = [f"## `{parser.name}`", "", f"```\n{parser.name} {parser.synopsis}\n```", ""]
    for spec in parser.specs:
        if isinstance(spec, Separator):
            text = " ".join(ln for ln in spec.lines if ln)
            if text:
                out.append(f"**{text}**\n")
            out.append("| Option | Argument(s) | Effect | Note(s) |")
            out.append("|-|-|-|-|")
        else:
            aliases = "<br>".join("`%s`" % a for a in spec.aliases)
            arg = spec.arg_doc or ""
            effect = " ".join(spec.help_lines)
            note = f"default={spec.default_doc}" if spec.default_doc else ""
            out.append(f"| {aliases} | {arg} | {effect} | {note} |")
    return "\n".join(out) + "\n"


def split_on_char(s: str, ch: str = ",") -> List[str]:
    return s.split(ch) if s else []


def parse_regexp_selector(option: str, s: str) -> List[tuple[str, str]]:
    """``<metadata_field>~<regexp>[,...]`` (bin/KPopCountDB.ml:81-92)."""
    out = []
    for part in s.split(","):
        pieces = part.split("~")
        if len(pieces) != 2:
            raise ParseError(
                f"Option '{option}': Wrong number of fields in list "
                f"(expected 2, found {len(pieces)})"
            )
        out.append((pieces[0], pieces[1]))
    return out
