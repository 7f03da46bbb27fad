"""Native docking: flexible-ligand pose search against a rigid pocket
(counterpart of ``singa_tpu/dock``).

Both the scoring function (``cpp/src/vina_score.cc``) and the search
(``cpp/src/vina_dock.cc``: MC basin hopping and pattern-search local
optimisation, threaded over exhaustiveness) are native in-process C++ behind
ctypes; they run on the host.
"""
from singa_tpu_torch.dock.engine import DockResult, conf_energy, dock
from singa_tpu_torch.dock.tree import interacting_pairs, torsion_tree

__all__ = ["DockResult", "conf_energy", "dock", "interacting_pairs", "torsion_tree"]
