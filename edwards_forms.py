#!/usr/bin/env python3
"""Times the port's batched EdDSA verify on one GPU with two forms of the
BabyJubJub projective add and double, in turns in one process:

* "plain": one field operation a call, as the reference writes them
  (owshen_tpu/curves/babyjubjub.py `add`, `double`): 20 and 15 K1 launches;
* "stacked": the products and sums of a formula that do not wait on each
  other stacked on a new leading axis and sent through one K1 launch: 8 and
  7 K1 launches, plus one torch.stack copy for each stacked operand.

    python3 edwards_forms.py [--n 4096] [--reps 3] [--rounds 2]

Signs n distinct seeded messages with eddsa_sign_batch, then verifies them
with each form in the order plain, stacked, stacked, plain (per round),
reps timed batches a turn after one untimed one.  Both forms must accept
every lane.  Prints the card's name and power limit, each turn's times
(host clock, synchronised) and K1 launches per verify, then one JSON line.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time


def plain_forms(F, A, D):
    def add(p, q):
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        a = F.mul(Z1, Z2)
        b = F.sqr(a)
        c = F.mul(X1, X2)
        d = F.mul(Y1, Y2)
        e = F.mul_const(F.mul(c, d), D)
        f = F.sub(b, e)
        g = F.add(b, e)
        x_part = F.sub(F.mul(F.add(X1, Y1), F.add(X2, Y2)), F.add(c, d))
        X3 = F.mul(F.mul(a, f), x_part)
        Y3 = F.mul(F.mul(a, g), F.sub(d, F.mul_const(c, A)))
        return (X3, Y3, F.mul(f, g))

    def double(p):
        X1, Y1, Z1 = p
        b = F.sqr(F.add(X1, Y1))
        c = F.sqr(X1)
        d = F.sqr(Y1)
        e = F.mul_const(c, A)
        f = F.add(e, d)
        h = F.sqr(Z1)
        j = F.sub(f, F.add(h, h))
        X3 = F.mul(F.sub(F.sub(b, c), d), j)
        return (X3, F.mul(f, F.sub(e, d)), F.mul(f, j))

    return add, double


def stacked_forms(torch, F, A, D):
    def muls(xs, ys):
        return F.mul(torch.stack(xs), torch.stack(ys)).unbind(0)

    def adds(xs, ys):
        return F.add(torch.stack(xs), torch.stack(ys)).unbind(0)

    def subs(xs, ys):
        return F.sub(torch.stack(xs), torch.stack(ys)).unbind(0)

    def add(p, q):
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        a, c, d = muls((Z1, X1, Y1), (Z2, X2, Y2))
        s1, s2, cpd = adds((X1, X2, c), (Y1, Y2, d))
        k_a = F.const(A, device=c.device).expand_as(c)
        b, cd, u, c_a = muls((a, c, s1, c), (a, d, s2, k_a))
        e = F.mul_const(cd, D)
        f, x_part, d_ca = subs((b, u, d), (e, cpd, c_a))
        g = F.add(b, e)
        af, ag, Z3 = muls((a, a, f), (f, g, g))
        X3, Y3 = muls((af, ag), (x_part, d_ca))
        return (X3, Y3, Z3)

    def double(p):
        X1, Y1, Z1 = p
        s = F.add(X1, Y1)
        b, c, d, h = muls((s, X1, Y1, Z1), (s, X1, Y1, Z1))
        e = F.mul_const(c, A)
        f, h2 = adds((e, h), (d, h))
        b_c, e_d = subs((b, e), (c, d))
        j, b_cd = subs((f, b_c), (h2, d))
        return muls((b_cd, f, f), (j, e_d, j))

    return add, double


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2)
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: edwards_forms.py runs only on a GPU", file=sys.stderr)
        return 1
    from owshen_tpu_torch import kernels
    from owshen_tpu_torch.curves import babyjubjub as jub
    from owshen_tpu_torch.fields.field import FR, ints_to_tensor
    from owshen_tpu_torch.oracle import eddsa as oeddsa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    n, rng = opts.n, random.Random(opts.n)
    priv = rng.randrange(1 << 250)
    pub = oeddsa.to_pub(priv)
    msgs = [rng.randrange(FR.p) for _ in range(n)]
    sigs = jub.eddsa_sign_batch([priv] * n, [rng.randrange(FR.p) for _ in range(n)], msgs,
                                device=dev)
    args = ((FR.encode([pub[0]] * n, device=dev), FR.encode([pub[1]] * n, device=dev)),
            FR.encode(msgs, device=dev),
            (FR.encode([r[0] for r, _ in sigs], device=dev),
             FR.encode([r[1] for r, _ in sigs], device=dev)),
            ints_to_tensor([s for _, s in sigs], dev))
    forms = {"plain": plain_forms(FR, jub.A, jub.D),
             "stacked": stacked_forms(torch, FR, jub.A, jub.D)}
    times = {name: [] for name in forms}
    k1 = {}
    for _ in range(opts.rounds):
        for name in ("plain", "stacked", "stacked", "plain"):
            jub.add, jub.double = forms[name]        # scalar_mul and JUB_OPS call these
            before = kernels.launch_counts()
            if not bool(jub.eddsa_verify(*args).all()):
                print(f"the {name} form rejected a valid signature", file=sys.stderr)
                return 1
            k1[name] = sum(v - before[k] for k, v in kernels.launch_counts().items()
                           if k in ("mont_mul", "mod_add", "mod_sub"))
            for _ in range(opts.reps):
                t = time.time()
                jub.eddsa_verify(*args)
                torch.cuda.synchronize()
                times[name].append(time.time() - t)
            print(f"{name}: {json.dumps([round(x, 4) for x in times[name][-opts.reps:]])} s a "
                  f"verify of {n}, {k1[name]} K1 launches", flush=True)
    line = {"n": n, "card": smi, "k1_launches": k1, "verify_s": times,
            "median_s": {k: sorted(v)[len(v) // 2] for k, v in times.items()}}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
