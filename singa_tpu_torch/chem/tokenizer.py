"""SMILES detokenisation (counterpart of ``singa_tpu/chem/tokenizer.py``)."""
from __future__ import annotations

import numpy as np

from singa_tpu_torch.config import SMI_VOCAB


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
