"""The port's `pool.synthesize` and `pool.check` spans (host clock around
the transaction circuit's values-only pass and the check of the key's kept
rows on the card) over the window, per proof: the withdraw cell's reader,
over this cell's window."""

from pathlib import Path

from benchmark.harness import load_file

read = load_file(Path(__file__).with_name("synth_ms_per_op.prove.py")).read
