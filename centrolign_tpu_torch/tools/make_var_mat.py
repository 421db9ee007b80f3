"""Variant matrix from an MSA graph's snarl decomposition (reference
src/scripts/make_var_mat.cpp).

Usage: python -m centrolign_tpu_torch.tools.make_var_mat [options] graph.gfa
       > var_mat.tsv

 --base / -b             Use bases in the output encoding
 --indels / -i           Include point indels (< --sv-lim)
 --mnvs / -m             Include multi-nucleotide variants (< --sv-lim)
 --svs / -s              Include structural variants (>= --sv-lim)
 --exclude-snvs / -x     Do *not* include single nucleotide variants
 --sv-lim / -l INT       Structural-variant size threshold [50]
 --allow-nest / -a       Allow nested variants if biallelic apart from
                         nested sites
 --full-repr / -f        Represent full base-level alleles for nested
                         variants instead of site identifiers
 --header / -n           Include the Phylip header line
 --chains / -c           Interleave chain IDs between variant columns
 --positions / -p        Interleave variant path positions
 --chain-ints / -C FILE  Write the path intervals through each chain
                         (per-chain rows ordered by ascending path id)

Variant typing, biallelic/simple/trivial snarl classification, column
assignment, and row encoding replicate the reference tool; outputs are
byte-identical on its inputs (tests/test_tools_scripts.py).

Copy of centrolign_tpu/tools/make_var_mat.py.
"""

from __future__ import annotations

import argparse
import sys

UNKNOWN, SNP, POINT_INDEL, MNV, SV = range(5)
_NONE = 2**64 - 1  # the reference's size_t -1 sentinel


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-b", "--base", action="store_true")
    ap.add_argument("-i", "--indels", action="store_true")
    ap.add_argument("-m", "--mnvs", action="store_true")
    ap.add_argument("-s", "--svs", action="store_true")
    ap.add_argument("-x", "--exclude-snvs", action="store_true")
    ap.add_argument("-l", "--sv-lim", type=int, default=50)
    ap.add_argument("-a", "--allow-nest", action="store_true")
    ap.add_argument("-f", "--full-repr", action="store_true")
    ap.add_argument("-n", "--header", action="store_true")
    ap.add_argument("-c", "--chains", action="store_true")
    ap.add_argument("-p", "--positions", action="store_true")
    ap.add_argument("-C", "--chain-ints", default="")
    ap.add_argument("gfa")
    args = ap.parse_args(argv)

    from ..extractor import StepIndex
    from ..io.gfa import read_gfa
    from ..modify_graph import add_sentinels
    from ..snarls import NetGraph, SnarlDistances, Snarls
    from ..utils.encoding import decode_seq

    try:
        with open(args.gfa) as f:
            graph = read_gfa(f)
    except OSError:
        print(f"error: could not open GFA file {args.gfa}", file=sys.stderr)
        return 1

    print("Loading graph...", file=sys.stderr)
    tableau = add_sentinels(graph, 5, 6)
    print("Finding snarls...", file=sys.stderr)
    snarls = Snarls(graph, tableau)
    print("Computing snarl sizes...", file=sys.stderr)
    dists = SnarlDistances(snarls, graph)

    print("Identifying snarl features...", file=sys.stderr)
    chain_trivial = [False] * snarls.chain_size
    snarl_trivial = [False] * snarls.structure_size
    snarl_simple = [False] * snarls.structure_size
    snarl_biallelic = [False] * snarls.structure_size

    for fid, is_chain in snarls.postorder():
        if is_chain:
            chain_trivial[fid] = all(
                snarl_trivial[s] for s in snarls.structures_inside(fid))
            continue
        if not snarls.snarl_is_acyclic(fid):
            continue
        src, snk = snarls.structure_boundaries(fid)
        nxt = graph.next(src)
        snarl_trivial[fid] = len(nxt) == 1 and int(nxt[0]) == snk
        _mn, mx = dists.structure_min_max_dist(fid)
        # max == -1 is the cyclic/unbounded sentinel (size_t -1 upstream)
        snarl_simple[fid] = mx != -1 and mx < args.sv_lim

        ng = NetGraph(graph, snarls, fid)
        net_src = net_snk = -1
        for net_id, lab in enumerate(ng.labels):
            if lab == (src, False):
                net_src = net_id
            if lab == (snk, False):
                net_snk = net_id
        assert net_src != -1 and net_snk != -1
        biallelic = True
        if len(ng.edges[net_src]) != 2:
            biallelic = False
        else:
            for nid in ng.edges[net_src]:
                if nid == net_snk:
                    continue  # deletion allele
                feat, is_c = ng.labels[nid]
                if is_c and not args.allow_nest and not chain_trivial[feat]:
                    biallelic = False
                    break
                if (len(ng.edges[nid]) != 1
                        or ng.edges[nid][0] != net_snk):
                    biallelic = False
                    break
        snarl_biallelic[fid] = biallelic

    print("Selecting variants...", file=sys.stderr)
    variants = []
    for sid in range(snarls.structure_size):
        if not (snarl_biallelic[sid] and not snarl_trivial[sid]):
            continue
        mn, mx = dists.structure_min_max_dist(sid)
        if mx == -1:
            mx = _NONE  # size_t -1: never "< sv_lim"
        if mn == mx and mn == 3:
            variants.append((sid, SNP))
        elif mn == 2 and mx < args.sv_lim:
            variants.append((sid, POINT_INDEL))
        elif mx < args.sv_lim:
            variants.append((sid, MNV))
        else:
            variants.append((sid, SV))

    source_to_column = {}
    column_var = []
    for sid, vt in variants:
        if ((vt == SNP and not args.exclude_snvs)
                or (vt == POINT_INDEL and args.indels)
                or (vt == MNV and args.mnvs)
                or (vt == SV and args.svs)):
            src, snk = snarls.structure_boundaries(sid)
            source_to_column[src] = (snk, len(source_to_column))
            column_var.append(sid)

    print("Outputting table...", file=sys.stderr)
    out = sys.stdout
    if args.header:
        out.write(f"{graph.path_size}\t{len(source_to_column)}\n")
    for pid in range(graph.path_size):
        row = [[] for _ in range(len(source_to_column))]
        path = [int(v) for v in graph.path(pid)]
        curr_vars = []         # [(snk, column), ...]
        containing_vars = []
        for i, v in enumerate(path):
            if curr_vars and curr_vars[-1][0] == v:
                curr_vars.pop()
                if containing_vars:
                    assert not curr_vars
                    curr_vars.append(containing_vars.pop())
            for _snk, col in curr_vars:
                row[col][-1][1].append(decode_seq([graph.labels[v]]))
            hit = source_to_column.get(v)
            if hit is not None:
                if not args.base:
                    nxt = [int(x) for x in graph.next(v)]
                    for j, nx in enumerate(nxt):
                        if nx == path[i + 1]:
                            row[hit[1]].append((i + 1, [str(j)]))
                            break
                else:
                    if curr_vars and not args.full_repr:
                        row[curr_vars[-1][1]][-1][1].append(
                            f"({hit[1]})")
                        containing_vars.append(curr_vars.pop())
                    row[hit[1]].append((i + 1, []))
                    curr_vars.append(hit)
        out.write(graph.path_name(pid))
        for col, alleles in enumerate(row):
            out.write("\t")
            if not alleles:
                if args.chains:
                    out.write(".\t")
                if args.positions:
                    out.write(".\t")
                out.write("?")
                continue
            if args.chains:
                out.write(
                    f"{snarls.chain_containing(column_var[col])}\t")
            if args.positions:
                out.write(",".join(str(p) for p, _ in alleles))
                out.write("\t")
            out.write(",".join("".join(s) if s else "-"
                               for _p, s in alleles))
        out.write("\n")

    if args.chain_ints:
        print("Indexing path steps for chain interval output...",
              file=sys.stderr)
        step_index = StepIndex(graph)
        with open(args.chain_ints, "w") as f:
            for cid in range(snarls.chain_size):
                inside = snarls.structures_inside(cid)
                left = snarls.structure_boundaries(inside[0])[0]
                right = snarls.structure_boundaries(inside[-1])[1]
                path_steps = {}
                f.write(f"{cid}\t")
                for node_id in (left, right):
                    for p, pos in step_index.path_steps(node_id):
                        path_steps.setdefault(p, []).append(pos)
                # the reference separates interval pairs with commas only
                # WITHIN one path's list (its `i != 0` check resets per
                # unordered_map entry); paths here iterate in ascending id
                for p in sorted(path_steps):
                    steps = sorted(path_steps[p])
                    assert len(steps) % 2 == 0
                    f.write(",".join(
                        f"{graph.path_name(p)}:{steps[i]}"
                        f"-{steps[i + 1] + 1}"
                        for i in range(0, len(steps), 2)))
                f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
