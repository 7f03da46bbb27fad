"""Command-line tools of the port: the ETL (``make_dataset``), re-docking
(``dock_ligand``) and the synthesized corpus (``gen_corpus_complexes``), each
run as ``python -m singa_tpu_torch.tools.<name>``."""
