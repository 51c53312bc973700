"""The benchmark harness: run one cell once (main.py) and its parts."""
