"""The port's `pool.synthesize` and `pool.check` spans (host clock around
the withdraw circuit's synthesis in Python and `Builder.check` on host
integers) over the window, per proof: the circuit build's share of the
groth16 layer's host work."""


def read(r):
    timers = r.get("timers", {})
    count, synth = timers.get("pool.synthesize", (0, 0.0))
    _, check = timers.get("pool.check", (0, 0.0))
    if not count:
        return None
    return 1e3 * (synth + check) / count
