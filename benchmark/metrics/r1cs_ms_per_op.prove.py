"""The port's `groth16.r1cs` span (host clock around `builder.compiled(n)`
and the matrices' upload in `groth16.prove`) over the window, per proof:
the constraint matrices rebuilt for every proof."""


def read(r):
    count, total = r.get("timers", {}).get("groth16.r1cs", (0, 0.0))
    if not count:
        return None
    return 1e3 * total / count
