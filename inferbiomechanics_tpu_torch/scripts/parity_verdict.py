"""The verdict of the port's whole-run quality studies against the JAX
package's, read from the studies' JSONs (``docs/port_parity/``).

The rules are those of ``PARITY_RMSE.md``, on force, CoP and COM-acc Avg
Err:

- per family, metric and statistic (best: a run's lowest value over its
  epochs; final: its last epoch's), the port's range over its seeds must
  overlap the JAX range over its seeds;
- per evaluated epoch, the port's seed mean must lie within the JAX range
  widened by its own width on each side;
- diffusion, of which the JAX side has one seed: at each evaluated epoch
  the JAX value must lie within the port's range widened by its own width
  on each side. The final sampling surfaces are held the same way.

Where more seeds of a family have been studied (``--more FAMILY JAX_GLOB
PORT_GLOB``: files of the JAX side's and the port's further seeds), the
first two rules are also applied to all of them (for diffusion, the range
rule to each final surface too) and reported beside the verdict, which
stays that of the files above.

Each port JSON's ``data_sha256`` must equal the study data's digest in
``study_data.json`` (``parity_rmse --digest-only``) for its format.

Two studies of the same seeds from the same initial weights (``--paired
A_GLOB B_GLOB``: say JAX's and the port's from JAX's weights,
``--init-from``) are held seed by seed: their relative differences by
metric; the first two rules are applied to the pair too, ``A`` as the JAX
side.

Run::

    python -m inferbiomechanics_tpu_torch.scripts.parity_verdict --dir docs/port_parity \
        --more feedforward 'jax_feedforward_seeds*.json' 'port_feedforward_seeds*.json' \
        --paired 'jax_transformer*.json' port_transformer_vpu_from_jax_inits.json

prints the tables in markdown, writes ``verdict.json`` (with the arguments)
beside the studies and exits 1 when a rule of the verdict misses.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np

METRICS = ('force_avg_err', 'cop_avg_err', 'com_acc_avg_err')
# (family, JAX file, port file, the format of the data it trained on)
FAMILIES = (
    ('feedforward', 'jax_feedforward.json', 'port_feedforward.json', 'last_frame'),
    ('groundlink', 'jax_groundlink.json', 'port_groundlink.json', 'all_frames'),
    ('transformer vpu', 'jax_transformer.json', 'port_transformer_vpu.json', 'all_frames'),
    ('transformer pallas', 'jax_transformer.json', 'port_transformer_pallas.json',
     'all_frames'),
)
DIFFUSION = ('diffusion', 'jax_diffusion.json', 'port_diffusion.json', 'all_frames')

Span = Tuple[float, float]


def curves(doc: dict) -> Dict[str, List[dict]]:
    """seed -> curve, from either layout: ``runs[seed].curve``, or the JAX
    ``parity_rmse.py``'s ``jax[seed]`` (a curve)."""
    if 'runs' in doc:
        return {s: r['curve'] for s, r in doc['runs'].items()}
    return dict(doc['jax'])


def merged(*docs: dict) -> dict:
    """The runs of several studies of one family as one study."""
    runs = {}
    for doc in docs:
        runs.update(doc['runs'] if 'runs' in doc else
                    {s: {'curve': c} for s, c in doc['jax'].items()})
    return {'runs': runs}


def span(values: Sequence[float]) -> Span:
    return float(min(values)), float(max(values))


def widened(r: Span) -> Span:
    w = r[1] - r[0]
    return r[0] - w, r[1] + w


def overlaps(a: Span, b: Span) -> bool:
    return a[0] <= b[1] and b[0] <= a[1]


def within(v: float, r: Span) -> bool:
    return r[0] <= v <= r[1]


def statistic(curve: List[dict], metric: str, which: str) -> float:
    return min(c[metric] for c in curve) if which == 'best' else curve[-1][metric]


def family_verdict(jax_doc: dict, port_doc: dict) -> dict:
    """The range rule by statistic and metric, and the widened-range rule
    by epoch, of a family trained by both sides for the same epochs."""
    jc, pc = curves(jax_doc), curves(port_doc)
    lengths = {len(c) for c in (*jc.values(), *pc.values())}
    if len(lengths) != 1:
        raise ValueError(f'curves of different lengths: {sorted(lengths)}')
    stats = []
    for which in ('best', 'final'):
        for m in METRICS:
            jv = [statistic(c, m, which) for c in jc.values()]
            pv = [statistic(c, m, which) for c in pc.values()]
            stats.append({'stat': which, 'metric': m, 'jax': span(jv), 'port': span(pv),
                          'jax_mean': float(np.mean(jv)), 'port_mean': float(np.mean(pv)),
                          'ok': overlaps(span(jv), span(pv))})
    epochs = []
    for ep in range(lengths.pop()):
        for m in METRICS:
            j = span([c[ep][m] for c in jc.values()])
            mean = float(np.mean([c[ep][m] for c in pc.values()]))
            epochs.append({'epoch': ep, 'metric': m, 'jax': j, 'band': widened(j),
                           'port_mean': mean, 'ok': within(mean, widened(j))})
    for surface in _finals(jax_doc):
        for m in METRICS:
            jv = [r['final'][surface][m] for r in jax_doc['runs'].values()]
            pv = [r['final'][surface][m] for r in port_doc['runs'].values()]
            stats.append({'stat': f'final {surface}', 'metric': m, 'jax': span(jv),
                          'port': span(pv), 'jax_mean': float(np.mean(jv)),
                          'port_mean': float(np.mean(pv)), 'ok': overlaps(span(jv), span(pv))})
    return {'seeds': {'jax': sorted(jc), 'port': sorted(pc)}, 'stats': stats,
            'epochs': epochs, 'ok': all(r['ok'] for r in stats + epochs)}


def _finals(doc: dict) -> List[str]:
    """The final sampling surfaces a diffusion study scored (none for the
    regression families, whose ``final`` is the last epoch's entry)."""
    run = next(iter(doc.get('runs', {}).values()), {})
    final = run.get('final', {})
    return [k for k, v in final.items() if isinstance(v, dict)]


def diffusion_verdict(jax_doc: dict, port_doc: dict) -> dict:
    """Every JAX seed's value inside the port's range widened by its own
    width, at each evaluated epoch and on each final surface."""
    jc, pc = curves(jax_doc), curves(port_doc)
    evals = [c['epoch'] for c in next(iter(pc.values()))]
    if any([c['epoch'] for c in curve] != evals for curve in (*jc.values(), *pc.values())):
        raise ValueError('the runs were evaluated at different epochs')
    epochs = []
    for i, ep in enumerate(evals):
        for m in METRICS:
            p = span([c[i][m] for c in pc.values()])
            j = [c[i][m] for c in jc.values()]
            epochs.append({'epoch': ep, 'metric': m, 'port': p, 'band': widened(p),
                           'jax': j, 'ok': all(within(v, widened(p)) for v in j)})
    finals = []
    for surface in _finals(jax_doc):
        for m in METRICS:
            p = span([r['final'][surface][m] for r in port_doc['runs'].values()])
            j = [r['final'][surface][m] for r in jax_doc['runs'].values()]
            finals.append({'surface': surface, 'metric': m, 'port': p, 'band': widened(p),
                           'jax': j, 'ok': all(within(v, widened(p)) for v in j)})
    return {'seeds': {'jax': sorted(jc), 'port': sorted(pc)}, 'epochs': epochs,
            'finals': finals, 'ok': all(r['ok'] for r in epochs + finals)}


def paired(a_doc: dict, b_doc: dict) -> dict:
    """Two studies of the same seeds from the same initial weights: for each
    metric, ``b``'s relative difference from ``a`` at every evaluated epoch
    and final surface of every seed (min, max, mean)."""
    a, b = merged(a_doc)['runs'], merged(b_doc)['runs']
    seeds = sorted(set(a) & set(b), key=int)
    out = {'seeds': seeds}
    for m in METRICS:
        rel = [(y[m] - x[m]) / x[m] for s in seeds
               for x, y in zip(a[s]['curve'], b[s]['curve'])]
        rel += [(b[s]['final'][k][m] - v[m]) / v[m] for s in seeds
                for k, v in a[s].get('final', {}).items() if isinstance(v, dict)]
        out[m] = (float(min(rel)), float(max(rel)), float(np.mean(rel)))
    return out


def _fmt(r: Span) -> str:
    return f'{r[0]:.4f}–{r[1]:.4f}'


def markdown(verdict: dict) -> List[str]:
    """The verdict as markdown tables: the range rule, then each miss of
    the epoch rule."""
    lines = ['| family | statistic | metric | JAX | port range (diffusion: widened) | verdict |',
             '| --- | --- | --- | --- | --- | --- |']
    for fam, v in verdict['families'].items():
        for r in v.get('stats', []):
            lines.append(f'| {fam} | {r["stat"]} | {r["metric"]} | {_fmt(r["jax"])} | '
                         f'{_fmt(r["port"])} | {"overlap" if r["ok"] else "MISS"} |')
        for r in v.get('finals', []):
            lines.append(f'| {fam} | final {r["surface"]} | {r["metric"]} | '
                         f'{", ".join(f"{x:.4f}" for x in r["jax"])} | {_fmt(r["band"])} | '
                         f'{"inside" if r["ok"] else "MISS"} |')
    for fam, v in verdict['more_seeds'].items():
        n = f'{len(v["seeds"]["jax"])} / {len(v["seeds"]["port"])} seeds'
        for r in v['stats']:
            lines.append(f'| {fam}, {n} | {r["stat"]} | {r["metric"]} | {_fmt(r["jax"])}, '
                         f'mean {r["jax_mean"]:.4f} | {_fmt(r["port"])}, mean '
                         f'{r["port_mean"]:.4f} | {"overlap" if r["ok"] else "MISS"} |')
    lines.append('')
    for what, families in (('', verdict['families']), (', all seeds', verdict['more_seeds'])):
        for fam, v in families.items():
            n, miss = len(v['epochs']), [r for r in v['epochs'] if not r['ok']]
            lines.append(f'- {fam}{what}: {n - len(miss)} of {n} (epoch, metric) cells within '
                         f'the widened range' + ('' if not miss else '; misses: ' + ', '.join(
                             f'epoch {r["epoch"] + 1} {r["metric"]}' for r in miss)))
    for name, v in verdict['paired'].items():
        lines.append(f'- {name}, seeds {",".join(v["seeds"])}: relative difference ' + '; '.join(
            f'{m} {v[m][0]:+.4f}..{v[m][1]:+.4f} (mean {v[m][2]:+.4f})' for m in METRICS))
        rules = v['rules']
        finals = [r for r in rules['stats'] if r['stat'] == 'final']
        lines.append(
            f'  - the rules on the pair: {sum(r["ok"] for r in rules["stats"])} of '
            f'{len(rules["stats"])} ranges overlap, {sum(r["ok"] for r in rules["epochs"])} of '
            f'{len(rules["epochs"])} epoch cells within the widened range; last epoch\'s '
            f'means A / B: ' + ', '.join(f'{r["metric"]} {r["jax_mean"]:.4f} / '
                                          f'{r["port_mean"]:.4f}' for r in finals))
    for name, ok in verdict['digests'].items():
        lines.append(f'- {name}: data_sha256 {"equals" if ok else "DIFFERS FROM"} the '
                     f'study data\'s')
    return lines


def verdict_of(directory: str, more: Sequence[Tuple[str, str, str]] = (),
               pairs: Sequence[Tuple[str, str]] = ()) -> dict:
    """The verdict of the studies in ``directory``; ``more``: (family, glob
    of the JAX side's further seeds, glob of the port's); ``pairs``: (glob
    of the first studies, glob of the second) held seed by seed."""
    def load(name):
        with open(os.path.join(directory, name)) as f:
            return json.load(f)

    def names(pattern):
        found = sorted(os.path.basename(p) for p in glob.glob(os.path.join(directory, pattern)))
        if not found:
            raise FileNotFoundError(f'no study in {directory} matches {pattern!r}')
        return found

    study = load('study_data.json')
    families, digests, more_seeds = {}, {}, {}
    for fam, jax_name, port_name, fmt in (*FAMILIES, DIFFUSION):
        port = load(port_name)
        digests[port_name] = port['data_sha256'] == study[fmt]
        rule = diffusion_verdict if fam == 'diffusion' else family_verdict
        families[fam] = rule(load(jax_name), port)
    formats = {fam: fmt for fam, _, _, fmt in (*FAMILIES, DIFFUSION)}
    for fam, jax_glob, port_glob in more:
        jax_name, port_name = next((j, p) for f, j, p, _ in (*FAMILIES, DIFFUSION) if f == fam)
        port_more = names(port_glob)
        for name in port_more:
            digests[name] = load(name)['data_sha256'] == study[formats[fam]]
        more_seeds[fam] = family_verdict(merged(*map(load, [jax_name, *names(jax_glob)])),
                                         merged(*map(load, [port_name, *port_more])))
    held = {}
    for a, b in pairs:
        a_doc, b_doc = merged(*map(load, names(a))), merged(*map(load, names(b)))
        held[f'{a} against {b}'] = dict(paired(a_doc, b_doc),
                                        rules=family_verdict(a_doc, b_doc))
    return {'families': families, 'more_seeds': more_seeds, 'paired': held,
            'digests': digests,
            'ok': all(v['ok'] for v in families.values()) and all(digests.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--dir', default=os.path.join('docs', 'port_parity'))
    ap.add_argument('--more', nargs=3, action='append', default=[],
                    metavar=('FAMILY', 'JAX_GLOB', 'PORT_GLOB'),
                    help='further seeds of FAMILY: the rules over all of them, reported '
                         'beside the verdict')
    ap.add_argument('--paired', nargs=2, action='append', default=[],
                    metavar=('A_GLOB', 'B_GLOB'),
                    help='two studies of the same seeds from the same initial weights, '
                         'held seed by seed')
    args = ap.parse_args(argv)
    if unknown := {fam for fam, *_ in args.more} - {f for f, *_ in (*FAMILIES, DIFFUSION)}:
        ap.error(f'--more: no family {sorted(unknown)}')
    verdict = verdict_of(args.dir, args.more, args.paired)
    verdict['args'] = {'more': args.more, 'paired': args.paired}
    print('\n'.join(markdown(verdict)))
    with open(os.path.join(args.dir, 'verdict.json'), 'w') as f:
        json.dump(verdict, f, indent=1)
    return 0 if verdict['ok'] else 1


if __name__ == '__main__':
    sys.exit(main())
