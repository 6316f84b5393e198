"""Twins of the research scripts in `experiments/`: the same protocols on
the port, writing under `experiments/h100/` (see `common.py`)."""
