"""PTB tokenizer (the port's own copy of `cvc_tpu/evaluation/tokenizer.py`,
pure Python: the same tokens for the same text).

The coco-caption toolkit's PTBTokenizer runs the Stanford CoreNLP Java jar
with `-preserveLines -lowerCase`; this module reproduces its observable
behavior on caption text rule by rule, pinned by the golden corpus in
`tests/data/ptb_golden.json`:

  * lowercase; whitespace + punctuation splitting;
  * contractions split PTB-style (``don't`` -> ``do n't``, ``dog's`` ->
    ``dog 's``, ``won't`` -> ``wo n't``, ``i'm`` -> ``i 'm``);
  * assimilations (``gonna`` -> ``gon na``, ``cannot`` -> ``can not``);
  * internal hyphens kept (``three-year-old`` stays one token);
  * brackets become -LRB-/-RRB-/... (dropped by the punctuation filter,
    matching pycocoevalcap's PUNCTUATIONS list);
  * numbers keep decimal points and digit commas (``5.50``, ``1,000``);
    currency/percent split (``$5`` -> ``$ 5``, ``50%`` -> ``50 %``) and
    the symbols survive (they are not in the PUNCTUATIONS list);
  * common abbreviations keep their period (``mr.``);
  * standalone punctuation ``. , ? ! : ; - -- ...`` and quote tokens are
    dropped from the output exactly like pycocoevalcap.
"""

from __future__ import annotations

import re

# coco-caption PTBTokenizer's PUNCTUATIONS list (dropped from output).
_PUNCTUATIONS = {
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
}

# CoreNLP keeps the period attached for common abbreviations.
_ABBREVIATIONS = {
    "mr.", "mrs.", "ms.", "dr.", "prof.", "st.", "jr.", "sr.", "vs.",
    "etc.", "inc.", "co.", "corp.", "ave.", "blvd.", "rd.", "no.",
    "a.m.", "p.m.", "u.s.", "u.k.", "e.g.", "i.e.",
}

# Assimilated forms CoreNLP splits (lowercased input -> token sequence).
_ASSIMILATIONS = {
    "cannot": ["can", "not"],
    "gonna": ["gon", "na"],
    "wanna": ["wan", "na"],
    "gotta": ["got", "ta"],
    "lemme": ["lem", "me"],
    "gimme": ["gim", "me"],
    "'tis": ["'t", "is"],
    "'twas": ["'t", "was"],
}

# n't contractions with irregular stems.
_IRREGULAR_NT = {"won't": ["wo", "n't"], "can't": ["ca", "n't"],
                 "shan't": ["sha", "n't"], "ain't": ["ai", "n't"]}

_CLITICS = ("'s", "'re", "'ve", "'ll", "'d", "'m")

_BRACKETS = {"(": "-LRB-", ")": "-RRB-", "[": "-LRB-", "]": "-RRB-",
             "{": "-LCB-", "}": "-RCB-"}

# Leading-apostrophe forms that stay attached (vs. a quote to strip).
_APOS_FORMS = {"'tis", "'twas", "'n", "'em", "'til", "'cause"}

# One word-ish token: digits with internal .,/: separators (and ordinal/
# unit suffixes: 2nd, 10km), letters with internal hyphens/periods/
# apostrophes, or a single non-space symbol.
_WORD_RE = re.compile(
    r"\d+(?:[.,:/]\d+)*(?:[a-z]+)?"  # 1,000  5.50  3:30  3/4  2nd  10km
    r"|[a-z]+(?:[.'/-][a-z]+)*\.?"   # words, hyphenated/slashed, abbrevs.
    r"|'[a-z]+"                      # leading-apostrophe forms ('tis, 'em)
    r"|\.\.\.+"                      # ellipsis
    r"|--+"                          # dashes
    r"|[^\sa-z0-9]"                  # any single symbol
)


def _split_word(tok: str) -> list[str]:
    """Apply PTB contraction/assimilation/abbreviation rules to one
    word-ish token."""
    if tok in _ASSIMILATIONS:
        return list(_ASSIMILATIONS[tok])
    if tok in _IRREGULAR_NT:
        return list(_IRREGULAR_NT[tok])
    if tok.endswith("n't") and len(tok) > 3:
        return [tok[:-3], "n't"]
    for cl in _CLITICS:
        if tok.endswith(cl) and len(tok) > len(cl):
            # recurse on the stem: "she'd've" -> "she 'd 've"
            return _split_word(tok[: -len(cl)]) + [cl]
    if tok.endswith(".") and tok not in _ABBREVIATIONS:
        # final period splits off unless a known abbreviation or an
        # internal-period form like "u.s." (heuristic: single period)
        if tok.count(".") == 1:
            return [tok[:-1], "."]
    return [tok]


def ptb_tokenize(text: str) -> list[str]:
    """Lowercase CoreNLP-PTB tokenization with the coco-caption
    punctuation tokens removed."""
    text = text.lower().strip()
    # normalize unicode quotes/dashes to ASCII before matching
    text = (text.replace("’", "'").replace("‘", "'")
                .replace("“", '"').replace("”", '"')
                .replace("—", "--").replace("–", "--")
                .replace("…", "..."))
    out: list[str] = []
    for tok in _WORD_RE.findall(text):
        if tok in _BRACKETS:
            out.append(_BRACKETS[tok])
            continue
        if tok == '"':
            out.append("''")  # quote token (dropped below)
            continue
        if tok[0].isdigit():
            out.append(tok)
            continue
        if tok.startswith("'") and len(tok) > 1 and tok not in _APOS_FORMS \
                and tok not in _ASSIMILATIONS:
            # a quoted word ('expert) — strip the quote token
            out.append("'")
            tok = tok[1:]
        if any(c.isalpha() for c in tok):
            out.extend(_split_word(tok))
        else:
            out.append(tok)
    return [t for t in out if t not in _PUNCTUATIONS]


def tokenize_corpus(entries: dict[str, list[str]]) -> dict[str, list[str]]:
    """{image_id: [sentence, ...]} -> {image_id: ['tok tok ...', ...]},
    mirroring PTBTokenizer.tokenize()'s dict-of-joined-tokens output."""
    return {k: [" ".join(ptb_tokenize(s)) for s in v]
            for k, v in entries.items()}
