"""Closed loop of one-sequence requests, as an interactive search sends them.

Each request is one sequence; the next is submitted when the previous
one's rows are added.  Requests come in rounds of ``round``, in shuffled
order: ``round - with_domain`` background genes and ``with_domain``
genes carrying a domain, each group's lengths one from each of its
equal-probability strata of a lognormal (median ``median_nt``, sigma
``sigma``, clipped to ``clip``).  The pool's domains are drawn from the
whole DB, one profile from each of ``pool_rounds * with_domain`` strata
by core size (lib/traffic.draw_domains), each as long as a third of its
gene in amino acids.  So every seed offers the same sizes, the same
spread of profile widths and the same share of hits, with other
profiles and paths.  A pool of
``pool_rounds`` rounds is made before the window and cycled.  Latency is
from submit to the last row added, over every request of the window.
"""

from __future__ import annotations

import numpy as np
from statistics import NormalDist

from portbench.lib import traffic as tr
from portbench.lib.loop import Unit


def _lengths(rng, mix: dict, n: int) -> np.ndarray:
    """n lengths, one from each of n equal-probability strata of the
    clipped lognormal, shuffled."""
    u = (np.arange(n) + rng.random(n)) / n
    z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
    L = np.exp(np.log(mix["median_nt"]) + mix["sigma"] * z)
    return rng.permutation(np.clip(L, *mix["clip"]).astype(int))


def _rounds(rng, prm, mix: dict, count: int) -> list[Unit]:
    """``count`` rounds of requests; the domains of all of them are drawn
    together, each as long as a third of its gene."""
    n, d = mix["round"], mix["with_domain"]
    lens = [(_lengths(rng, mix, n - d), _lengths(rng, mix, d)) for _ in range(count)]
    domains = tr.draw_domains(rng, prm, count * d,
                              np.concatenate([h for _, h in lens]) // 3)
    out = []
    for r, (bg, hom) in enumerate(lens):
        units = [Unit([tr.background(rng, 1, int(L))[0].tobytes().decode()],
                      np.array([-1]), [0]) for L in bg]
        for (p, aminos), L in zip(domains[r * d : (r + 1) * d], hom):
            units.append(Unit([tr.homolog(rng, aminos, int(L), mix["substitution"])],
                              np.array([p]), [0]))
        out += [units[i] for i in rng.permutation(n)]
    return out


def generate(mix: dict, prm, seed: int):
    """(pool of units, warm-up units, (1, longest request))."""
    rng = tr.rng_of(seed, 2)
    pool = _rounds(rng, prm, mix, mix["pool_rounds"])
    # a round's requests with a domain first: the warm-up reaches pass 2
    warm = sorted(_rounds(rng, prm, mix, 1), key=lambda u: u.source[0] < 0)[:4]
    return pool, warm, (1, int(mix["clip"][1]))


def end_to_end(records) -> dict:
    lat = 1e3 * np.array([r.end - r.start for r in records])
    return {"query_p50_ms": (float(np.percentile(lat, 50)), "ms"),
            "query_p90_ms": (float(np.percentile(lat, 90)), "ms")}
