"""Command-line entry points: ``yabpe-torch-train`` (cli/train_bpe.py) and
``yabpe-torch-bench`` (cli/bench.py)."""
