"""The port's `groth16.ladders` span (host clock around the legacy
prover's 254-step double-and-add ladders, one of five lanes on G1 and one
on G2, and the adds around them; it launches and does not wait for the
card) over the window, per proof."""


def read(r):
    count, total = r.get("timers", {}).get("groth16.ladders", (0, 0.0))
    if not count:
        return None
    return 1e3 * total / count
