"""The benchmark's host-clock span around each `prove_withdraw` call minus
the port's `pool.prove_withdraw` timer inside it, per proof: the protocol
layer's tree path, witness and circuit build."""


def read(r):
    count, total = r.get("timers", {}).get("pool.prove_withdraw", (0, 0.0))
    if not count or not r["calls"]:
        return None
    return 1e3 * (r["host_s"] - total) / r["calls"]
