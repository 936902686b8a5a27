"""The port's `pool.prove_transaction` span (host clock around
`groth16.prove`, which returns host integers, so it ends in a sync) over
the window, per proof: the Groth16 layer's time."""


def read(r):
    count, total = r.get("timers", {}).get("pool.prove_transaction", (0, 0.0))
    if not count:
        return None
    return 1e3 * total / count
