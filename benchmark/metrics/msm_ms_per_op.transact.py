"""The port's `groth16.msm` span (host clock around the legacy prover's
MSMs: `msm_sorted_many` over the four G1 sets and `msm_sorted` on G2; it
launches and does not wait for the card) over the window, per proof."""


def read(r):
    count, total = r.get("timers", {}).get("groth16.msm", (0, 0.0))
    if not count:
        return None
    return 1e3 * total / count
