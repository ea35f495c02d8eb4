"""Name quoting rules shared by all KPop text formats.

Mirrors the behaviour of the reference's
``Matrix.Base.strip_external_quotes_and_check`` (used at e.g.
the reference's lib/KMerDB.ml:437 and bin/KPopCount.ml:45):
names may arrive wrapped in one pair of external double quotes, which are
stripped; any *internal* double quote (or tab) is an error.
"""

from __future__ import annotations


class QuotesInName(ValueError):
    pass


def strip_external_quotes_and_check(s: str) -> str:
    """Strip one pair of external double quotes; reject internal quotes/tabs."""
    if len(s) >= 2 and s[0] == '"' and s[-1] == '"':
        s = s[1:-1]
    if '"' in s or "\t" in s:
        raise QuotesInName(s)
    return s


def quote(s: str) -> str:
    """Wrap a name in double quotes (KPop matrix text convention)."""
    return '"' + s + '"'
