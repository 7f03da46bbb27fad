"""SMILES tokenisation, index encoding and detokenisation (counterpart of
``singa_tpu/chem/tokenizer.py``; reference utils/PLParser.py:351-375): split
a SMILES string into the smallest vocabulary units, encode to fixed-length
index arrays with '&' (start), '$' (end) and '^' (padding) markers, and back.
"""
from __future__ import annotations

import re

import numpy as np

from singa_tpu_torch.config import EOS_TOKEN, PAD_TOKEN, SMI_VOCAB, SOS_TOKEN

_PATTERN = (
    r"(\[[^\]]+]|Br?|Cl?|Mg?|Al?|Na?|Li?|Pb?|Hg?|Au?|Ag?|Ca?|Fe?|As?|Be?|Sb?|Sn?"
    r"|Pd?|Co?|Se?|Ti?|Zn?|Ge?|Cu?|Ni?|Cd?|In?|Mn?|Zr?|Cr?|Pt?|Ga?"
    r"|N|O|S|P|F|I|K|k|V|v|H|h|b|c|n|o|s|p"
    r"|\(|\)|\.|=|#|-|\+|\\|\/|:|~|@|\?|>|\*|\$|\%[0-9]{2}|[0-9])"
)
_REGEX = re.compile(_PATTERN)

_VOCAB_INDEX = {tok: i for i, tok in enumerate(SMI_VOCAB)}


def split_smiles(smi: str) -> list[str]:
    """Split a SMILES string into vocabulary tokens; round-trip exact."""
    tokens = _REGEX.findall(smi)
    if "".join(tokens) != smi:
        raise ValueError(f"tokenisation is lossy for {smi!r}")
    return tokens


def encode(smi: str, tgt_len: int = 200) -> tuple[np.ndarray, np.ndarray]:
    """Encode to (input, target) int32 arrays of length ``tgt_len``.

    input  = '&' + tokens + '^'*pad
    target = tokens + '$' + '^'*pad
    (reference fetchIndices, PLParser.py:364-375)
    """
    tokens = split_smiles(smi)
    try:
        ids = [_VOCAB_INDEX[t] for t in tokens]
    except KeyError as e:
        raise ValueError(f"token {e.args[0]!r} not in vocabulary") from None
    if len(ids) + 1 > tgt_len:
        raise ValueError(f"SMILES too long ({len(ids)} tokens) for tgt_len={tgt_len}")
    inp = np.full(tgt_len, PAD_TOKEN, dtype=np.int32)
    tgt = np.full(tgt_len, PAD_TOKEN, dtype=np.int32)
    inp[0] = SOS_TOKEN
    inp[1 : len(ids) + 1] = ids
    tgt[: len(ids)] = ids
    tgt[len(ids)] = EOS_TOKEN
    return inp, tgt


def decode(ids, strip_markers: bool = True) -> str:
    """Index array -> SMILES string; drops '&', '$', '^' and stops at the
    first '$' (reference gen.py:200-213 strips them with a regex)."""
    toks = []
    for i in np.asarray(ids).reshape(-1):
        tok = SMI_VOCAB[int(i)]
        if strip_markers and tok in ("&", "$", "^"):
            if tok == "$":
                break
            continue
        toks.append(tok)
    return "".join(toks)
