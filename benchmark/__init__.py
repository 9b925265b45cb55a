"""The benchmark of arriba_tpu_torch (run.py is its entry)."""
