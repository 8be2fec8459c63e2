"""Built-in keyboard-layout substitution maps and the ``.table`` emitter.

The reference ships six hand-authored ``.table`` artifacts (SURVEY.md §2.2) —
qwerty→azerty, qwerty→cyrillic (ЙЦУКЕН), qwerty→greek, greek→hebrew
transliteration, czech diacritics and german umlauts — and its README describes
a whole family of direction-reversed variants (``azerty-qwerty.table`` is
referenced at ``README.MD:112,147,154`` but not checked in). Here those layouts
are first-class data: ordered ``(key, value)`` pair lists in keyboard scan
order, an emitter that regenerates each checked-in artifact **byte-identically**
(golden-tested against the reference files), and utilities to derive new
tables (direction inversion, bidirectional merge) instead of hand-authoring
them.

A Layout is an ordered sequence of pairs, NOT a dict: the reference format
allows repeated keys (alternative substitutions append in file order —
``main.go:141``) and repeated key=value lines (multiplicity matters, Q7), and
the emitted line order must round-trip byte-exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Tuple

from .parser import SubstitutionMap

Pair = Tuple[str, str]


@dataclass(frozen=True)
class Layout:
    """An ordered substitution layout plus its on-disk serialization style."""

    name: str
    pairs: Tuple[Pair, ...]
    eol: str = "\n"  # qwerty-azerty.table uses CRLF; the other artifacts LF
    description: str = ""

    def to_table_bytes(self) -> bytes:
        """Serialize to reference ``.table`` format (one key=value per line,
        trailing newline). Keys containing ``=`` or leading ``#``/whitespace
        would not survive a parse round-trip, so they are $HEX[]-escaped."""
        lines = []
        for key, value in self.pairs:
            lines.append(f"{_escape_key(key)}={_escape_value(value)}{self.eol}")
        return "".join(lines).encode("utf-8")

    def to_substitution_map(self) -> SubstitutionMap:
        """Parsed form: key bytes -> ordered list of value bytes (with
        append-per-key multiplicity, exactly as the parser would produce)."""
        out: Dict[bytes, List[bytes]] = {}
        for key, value in self.pairs:
            out.setdefault(key.encode("utf-8"), []).append(value.encode("utf-8"))
        return out

    def inverted(self, name: str | None = None) -> "Layout":
        """Swap substitution direction (e.g. qwerty→greek ⇒ greek→qwerty),
        preserving pair order — the reference's naming convention for this is
        ``B-A.table`` from ``A-B.table`` (``README.MD:146-148``)."""
        return replace(
            self,
            name=name or _invert_name(self.name),
            pairs=tuple((v, k) for k, v in self.pairs),
        )

    def merged_with(self, other: "Layout", name: str) -> "Layout":
        """Concatenate two layouts (order preserved) — how the reference's
        bidirectional qwerty-azerty table is structured (both directions in
        one file, SURVEY.md §2.2)."""
        return replace(self, name=name, pairs=self.pairs + other.pairs)


def _invert_name(name: str) -> str:
    parts = name.split("-")
    return "-".join(reversed(parts)) if len(parts) == 2 else f"{name}-inverted"


def _needs_hex(text: str) -> bool:
    # Anything that would not survive a parse round-trip verbatim: leading /
    # trailing whitespace (TrimSpace), embedded line breaks (line structure),
    # or a literal "$HEX[" prefix (would be decoded on re-parse).
    return (
        text != text.strip()
        or "\n" in text
        or "\r" in text
        or text.startswith("$HEX[")
    )


def _hex_escape(text: str) -> str:
    return "$HEX[" + text.encode("utf-8").hex() + "]"


def _escape_key(key: str) -> str:
    # An empty key is emitted raw: the line "=value" parses back to the empty
    # key (main.go:123 SplitN semantics), whereas "$HEX[]" would NOT decode
    # (the reference's len<7 passthrough keeps it as a literal 6-byte key).
    if key and ("=" in key or key.startswith("#") or _needs_hex(key)):
        return _hex_escape(key)
    return key


def _escape_value(value: str) -> str:
    if _needs_hex(value):
        return _hex_escape(value)
    return value


def _pairs(spec: str, eol: str = "\n") -> Tuple[Pair, ...]:
    """Parse an inline ``k=v`` spec (first ``=`` splits, like the reference)."""
    out = []
    for line in spec.strip("\n").split("\n"):
        k, _, v = line.partition("=")
        out.append((k, v))
    return tuple(out)


# --- Built-in layouts, in the reference artifacts' exact line order ---------

QWERTY_CYRILLIC = Layout(
    "qwerty-cyrillic",
    _pairs(
        "q=й\nQ=Й\nw=ц\nW=Ц\ne=у\nE=У\nr=к\nR=К\nt=е\nT=Е\ny=н\nY=Н\n"
        "u=г\nU=Г\ni=ш\nI=Ш\no=щ\nO=Щ\np=з\nP=З\na=ф\nA=Ф\ns=ы\nS=Ы\n"
        "d=в\nD=В\nf=а\nF=А\ng=п\nG=П\nh=р\nH=Р\nj=о\nJ=О\nk=л\nK=Л\n"
        "l=д\nL=Д\n;=ж\n;=Ж\n'=э\n'=Э\nz=я\nZ=Я\nx=ч\nX=Ч\nc=с\nC=С\n"
        "v=м\nV=М\nb=и\nB=И\nn=т\nN=Т\nm=ь\nM=Ь\n,=б\n,=Б\n.=ю\n.=Ю"
    ),
    description="Full qwerty→ЙЦУКЕН, upper+lower; ';' ''' ',' '.' have 2 options",
)

QWERTY_GREEK = Layout(
    "qwerty-greek",
    _pairs(
        '"=:\n;=΄\n`=;\na=α\nb=β\nc=ψ\nd=δ\ne=ρ\nf=φ\ng=γ\nh=η\ni=ο\n'
        "j=ξ\nk=κ\nl=λ\nm=μ\nn=ν\no=π\nq=ς\nr=τ\ns=σ\nt=υ\nu=ι\nv=ω\n"
        "w=ε\nx=χ\ny=θ\nz=ζ"
    ),
    description="qwerty→greek incl. punctuation, lowercase only",
)

GREEK_HEBREW = Layout(
    "greek-hebrew",
    _pairs(
        "ς=ק\nε=ר\nρ=א\nτ=ט\nυ=ו\nθ=ן\nι=י\nο=ח\nπ=פ\nα=ש\nσ=ד\nδ=ג\n"
        "φ=כ\nγ=ע\nη=י\nξ=ח\nκ=ל\nλ=ך\n΄=ף\n'=ף\nζ=ז\nχ=ס\nψ=ב\nω=מ\n"
        "β=נ\nν=מ\nμ=צ\n,=ת\n.=ץ"
    ),
    description="greek→hebrew transliteration, both sides multi-byte UTF-8",
)

CZECH = Layout(
    "czech",
    _pairs(
        "A=Á\nE=É\nI=Í\nO=Ó\nU=Ú\nY=Ý\na=á\ne=é\ni=í\no=ó\nu=ú\ny=ý\n"
        "C=Č\nD=Ď\nE=Ě\nN=Ň\nR=Ř\nS=Š\nT=Ť\nZ=Ž\nc=č\nd=ď\ne=ě\nn=ň\n"
        "r=ř\ns=š\nt=ť\nz=ž\nU=Ů\nu=ů"
    ),
    description="ASCII→czech diacritics; E/U/u have 2 options (length-changing)",
)

GERMAN = Layout(
    "german",
    _pairs("A=ä\nO=ö\nU=ü\na=ä\no=ö\nu=ü\nss=ß\nZ=ß"),
    description="German umlauts + multi-char key ss=ß",
)

QWERTY_AZERTY = Layout(
    "qwerty-azerty",
    _pairs(
        "q=a\nw=z\na=q\n;=m\nz=w\nm=,\n,=;\n.=:\n/=!\n1=&\n2=é\n3=\"\n"
        "4='\n5=(\n6=§\n7=è\n8=!\n9=ç\n0=à\n-=)\n/=-\n*=$\nm=;\n,=m\n"
        ";=,\n:=.\n!=/\n&=1\né=2\n\"=3\n'=4\n(=5\n§=6\nè=7\n!=8\nç=9\n"
        "à=0\n)=-\n-=/\n$=*\nQ=A\nW=Z\nA=Q\nZ=W\n;=M\nM=;\n,=M\nQ=a\n"
        "W=z\nA=q\nZ=w\nM=,"
    ),
    eol="\r\n",  # the checked-in artifact is CRLF-terminated
    description="qwerty↔azerty both directions merged + case pairs",
)

BUILTIN_LAYOUTS: Dict[str, Layout] = {
    layout.name: layout
    for layout in (
        QWERTY_CYRILLIC,
        QWERTY_GREEK,
        GREEK_HEBREW,
        CZECH,
        GERMAN,
        QWERTY_AZERTY,
    )
}

#: Derived layouts the reference documents but never checked in
#: (``README.MD:112,147,154``): direction-reversed variants.
DERIVED_LAYOUTS: Dict[str, Layout] = {
    inv.name: inv
    for inv in (
        QWERTY_CYRILLIC.inverted(),  # cyrillic-qwerty
        QWERTY_GREEK.inverted(),  # greek-qwerty
        GREEK_HEBREW.inverted(),  # hebrew-greek
        QWERTY_AZERTY.inverted(),  # azerty-qwerty
    )
}


def get_layout(name: str) -> Layout:
    try:
        return BUILTIN_LAYOUTS.get(name) or DERIVED_LAYOUTS[name]
    except KeyError:
        known = sorted(BUILTIN_LAYOUTS) + sorted(DERIVED_LAYOUTS)
        raise KeyError(f"unknown layout {name!r}; built-ins: {known}") from None


def emit_table(layout: Layout, path: str) -> None:
    """Write a layout to a ``.table`` file in the reference format."""
    with open(path, "wb") as fh:
        fh.write(layout.to_table_bytes())
