"""Runnable scripts of the port: `python -m wheeledlab_torch.scripts.<name>`
(CUDA by default; `--device cpu` on request)."""
