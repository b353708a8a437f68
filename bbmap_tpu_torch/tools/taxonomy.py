"""Taxonomy tools: NCBI tree loading, lineage printing, LCA, filtering.

reference: tax/ package — TaxTree.java:24 (nodes.dmp tree), GiToNcbi,
PrintTaxonomy, FindAncestor, FilterByTaxa, SortByTaxa
(SURVEY §2.10). Works from standard NCBI dump files (nodes.dmp,
names.dmp).
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Set

from ..io import fastx
from ..utils.args import Args


class TaxTree:
    """reference: tax/TaxTree.java — parent/rank arrays from nodes.dmp
    plus scientific names from names.dmp."""

    def __init__(self):
        self.parent: Dict[int, int] = {}
        self.rank: Dict[int, str] = {}
        self.name: Dict[int, str] = {}
        self.name_to_id: Dict[str, int] = {}

    @classmethod
    def load(cls, nodes_path: str,
             names_path: Optional[str] = None) -> "TaxTree":
        t = cls()
        with fastx.xopen(nodes_path, "rt") as fh:
            for line in fh:
                f = [x.strip() for x in line.split("|")]
                if len(f) < 3:
                    continue
                tid, par, rank = int(f[0]), int(f[1]), f[2]
                t.parent[tid] = par
                t.rank[tid] = rank
        if names_path:
            with fastx.xopen(names_path, "rt") as fh:
                for line in fh:
                    f = [x.strip() for x in line.split("|")]
                    if len(f) >= 4 and f[3] == "scientific name":
                        t.name[int(f[0])] = f[1]
                        t.name_to_id[f[1].lower()] = int(f[0])
        return t

    def save_serialized(self, path: str) -> None:
        """Serialized tree file — the analog of the reference's
        tree.taxtree.gz (reference: tax/TaxTree.java main)."""
        import pickle
        with fastx.xopen(path, "wb") as fh:
            pickle.dump(
                {"parent": self.parent, "rank": self.rank,
                 "name": self.name, "name_to_id": self.name_to_id}, fh)

    @classmethod
    def load_serialized(cls, path: str) -> "TaxTree":
        import pickle
        with fastx.xopen(path, "rb") as fh:
            d = pickle.load(fh)
        t = cls()
        t.parent, t.rank = d["parent"], d["rank"]
        t.name, t.name_to_id = d["name"], d["name_to_id"]
        return t

    def lineage(self, tid: int) -> List[int]:
        out = []
        seen = set()
        while tid in self.parent and tid not in seen:
            out.append(tid)
            seen.add(tid)
            par = self.parent[tid]
            if par == tid:
                break
            tid = par
        return out

    def lca(self, tids: List[int]) -> int:
        """reference: tax/FindAncestor.java."""
        if not tids:
            return 1
        common: Optional[List[int]] = None
        for tid in tids:
            lin = self.lineage(tid)
            if common is None:
                common = lin
            else:
                sl = set(lin)
                common = [x for x in common if x in sl]
        return common[0] if common else 1

    def is_descendant(self, tid: int, ancestor: int) -> bool:
        return ancestor in self.lineage(tid)

    def resolve(self, token: str) -> Optional[int]:
        try:
            return int(token)
        except ValueError:
            return self.name_to_id.get(token.lower())


def printtaxonomy(argv: List[str]) -> int:
    """reference: tax/PrintTaxonomy.java + sh/printtaxonomy.sh."""
    args = Args.parse(argv)
    nodes = args.get("tree", "nodes")
    names = args.get("names")
    query = args.get("id", "name") or (args.positional[0]
                                       if args.positional else None)
    if nodes is None or query is None:
        print("Usage: printtaxonomy nodes=<nodes.dmp> [names=<names.dmp>]"
              " id=<taxid|name>", file=sys.stderr)
        return 1
    t = _load_tree(args)
    tid = t.resolve(query)
    if tid is None:
        print(f"Could not resolve {query!r}", file=sys.stderr)
        return 1
    for x in t.lineage(tid):
        nm = t.name.get(x, "")
        print(f"{t.rank.get(x, '?')}\t{x}\t{nm}")
    return 0


def findancestor(argv: List[str]) -> int:
    args = Args.parse(argv)
    nodes = args.get("tree", "nodes")
    ids = args.get("ids", "id")
    names = args.get("names")
    if nodes is None or ids is None:
        print("Usage: findancestor nodes=<nodes.dmp> ids=1234,5678",
              file=sys.stderr)
        return 1
    t = _load_tree(args)
    tids = [t.resolve(x) for x in ids.split(",")]
    tids = [x for x in tids if x is not None]
    anc = t.lca(tids)
    print(f"{anc}\t{t.rank.get(anc, '?')}\t{t.name.get(anc, '')}")
    return 0


def filterbytaxa(argv: List[str]) -> int:
    """Keep sequences whose header taxid descends from the given node
    (reference: tax/FilterByTaxa.java). Headers carry 'tid|<n>' or
    'taxid=<n>' markers, or a name resolvable via names.dmp."""
    args = Args.parse(argv)
    nodes = args.get("tree", "nodes")
    names = args.get("names")
    inp = args.get("in")
    out = args.get("out")
    node = args.get("taxa", "id")
    include = args.get_bool("include", default=True)
    if None in (nodes, inp, out, node):
        print("Usage: filterbytaxa nodes= in= out= taxa=<taxid>",
              file=sys.stderr)
        return 1
    t = _load_tree(args)
    target = t.resolve(node)

    def header_tid(h: str) -> Optional[int]:
        for tok in h.replace("|", " ").replace("=", " ").split():
            pass
        import re as _re
        m = _re.search(r"(?:tid\||taxid[= ]|tax_id[= ])(\d+)", h)
        if m:
            return int(m.group(1))
        return None

    kept = 0
    fmt = fastx.sniff_format(inp)

    def gen():
        nonlocal kept
        for rec in fastx.read_seqs(inp):
            tid = header_tid(rec.id)
            hit = tid is not None and t.is_descendant(tid, target)
            if hit == include:
                kept += 1
                yield rec

    if fmt == "fasta":
        fastx.write_fasta(out, gen())
    else:
        fastx.write_fastq(out, gen())
    sys.stderr.write(f"Kept:\t{kept}\n")
    return 0


def _load_tree(args: Args) -> Optional["TaxTree"]:
    """Load a TaxTree from tree= (serialized .taxtree[.gz] or nodes.dmp)
    plus optional names=. The serialized form is the analog of the
    reference's tree.taxtree.gz (reference: tax/TaxTree.java
    loadTaxTree)."""
    tree = args.get("tree", "nodes", "taxtree")
    names = args.get("names")
    if tree is None:
        return None
    if ".taxtree" in tree or tree.endswith(".pkl") \
            or tree.endswith(".pkl.gz"):
        return TaxTree.load_serialized(tree)
    return TaxTree.load(tree, names)


def taxtree_build(argv: List[str]) -> int:
    """reference: taxtree.sh (tax/TaxTree.main) — build tree.taxtree.gz
    from names.dmp and nodes.dmp. Usage: taxtree names.dmp nodes.dmp
    tree.taxtree.gz (or names= nodes= out=)."""
    args = Args.parse(argv)
    pos = [a for a in argv if "=" not in a]
    names = args.get("names") or (pos[0] if len(pos) > 0 else None)
    nodes = args.get("nodes") or (pos[1] if len(pos) > 1 else None)
    out = args.get("out") or (pos[2] if len(pos) > 2
                              else "tree.taxtree.gz")
    if names is None or nodes is None:
        print("Usage: taxtree <names.dmp> <nodes.dmp> "
              "<tree.taxtree.gz>", file=sys.stderr)
        return 1
    t = TaxTree.load(nodes, names)
    t.save_serialized(out)
    sys.stderr.write(f"Nodes:\t{len(t.parent)}\n")
    return 0


def gitable(argv: List[str]) -> int:
    """reference: gitable.sh (tax/GiToNcbi.main) — build the gi->taxid
    table from gi_taxid_nucl.dmp / gi_taxid_prot.dmp (tab-separated
    'gi taxid' lines, gz ok). Output: .npz with the dense int32 array
    (analog of gitable.int1d.gz)."""
    args = Args.parse(argv)
    pos = [a for a in argv if "=" not in a]
    ins = args.get("in") or (pos[0] if pos else None)
    out = args.get("out") or (pos[1] if len(pos) > 1
                              else "gitable.npz")
    if ins is None:
        print("Usage: gitable <gi_taxid_nucl.dmp[.gz][,more]> "
              "<gitable.npz>", file=sys.stderr)
        return 1
    import numpy as np
    pairs: List[tuple] = []
    maxgi = 0
    for p in ins.split(","):
        with fastx.xopen(p, "rt") as fh:
            for line in fh:
                tab = line.find("\t")
                if tab <= 0:
                    continue
                gi = int(line[:tab])
                tid = int(line[tab + 1:].strip())
                pairs.append((gi, tid))
                maxgi = max(maxgi, gi)
    arr = np.full(maxgi + 1, -1, np.int32)
    for gi, tid in pairs:
        arr[gi] = tid
    np.savez_compressed(out if out.endswith(".npz") else out + ".npz",
                        gi2tid=arr)
    sys.stderr.write(f"Entries:\t{len(pairs)}\nMaxGi:\t{maxgi}\n")
    return 0


def _parse_gi(header: str) -> int:
    """reference: tax/GiToNcbi.parseGiNumber — 'gi|1234|...' or
    'gi_1234_...' -> 1234, else -1."""
    if not header.startswith("gi"):
        return -1
    for delim in ("|", "_"):
        i = header.find(delim)
        if i >= 0:
            j = i + 1
            num = 0
            if j >= len(header) or not header[j].isdigit():
                return -1
            while j < len(header) and header[j].isdigit():
                num = num * 10 + ord(header[j]) - 48
                j += 1
            return num
    return -1


def gi2taxid(argv: List[str]) -> int:
    """reference: gi2taxid.sh (tax/RenameGiToNcbi.java) — rename
    'gi|1234|...' headers to 'ncbi|<taxid>|...' using the gi table."""
    args = Args.parse(argv)
    inp = args.get("in") or (args.positional[0]
                             if args.positional else None)
    out = args.get("out")
    table = args.get("table", "gi")
    if None in (inp, out, table):
        print("Usage: gi2taxid in=<fa> out=<fa> table=<gitable.npz>",
              file=sys.stderr)
        return 1
    import numpy as np
    arr = np.load(table)["gi2tid"]
    invalid = 0

    def gen():
        nonlocal invalid
        for rec in fastx.read_seqs(inp):
            gi = _parse_gi(rec.id)
            if gi >= 0 and gi < len(arr) and arr[gi] >= 0:
                rest = rec.id.split("|", 2)
                tail = ("|" + rest[2]) if len(rest) > 2 else ""
                rec.id = f"ncbi|{int(arr[gi])}{tail}"
            else:
                invalid += 1
            yield rec
    fmt = fastx.sniff_format(out)
    if fmt == "fastq":
        fastx.write_fastq(out, gen())
    else:
        fastx.write_fasta(out, gen())
    if invalid:
        sys.stderr.write(f"Unrenamed:\t{invalid}\n")
    return 0


def gi2ancestors(argv: List[str]) -> int:
    """reference: gi2ancestors.sh (tax/FindAncestor.java) — for each
    input line 'name<TAB>gi,gi,gi' print the LCA taxid."""
    args = Args.parse(argv)
    inp = args.get("in") or (args.positional[0]
                             if args.positional else None)
    out = args.get("out")
    table = args.get("table", "gi")
    t = _load_tree(args)
    if None in (inp, table) or t is None:
        print("Usage: gi2ancestors in=<file> out=<file> "
              "table=<gitable.npz> tree=<tree.taxtree.gz>",
              file=sys.stderr)
        return 1
    import numpy as np
    arr = np.load(table)["gi2tid"]
    oh = fastx.xopen(out, "wt") if out else sys.stdout
    with fastx.xopen(inp, "rt") as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            gis = [int(x) for x in parts[-1].split(",") if x]
            tids = [int(arr[g]) for g in gis
                    if 0 <= g < len(arr) and arr[g] >= 0]
            anc = t.lca(tids)
            name = parts[0] if len(parts) > 1 else parts[-1]
            oh.write(f"{name}\t{anc}\t{t.name.get(anc, '')}\n")
    if out:
        oh.close()
    return 0


def _tax_sort_key(t: "TaxTree", tid: Optional[int]):
    """Total order matching tax/SortByTaxa.taxaComparator: lineage path
    from the root (so related taxa adjoin), unknown taxa last."""
    if tid is None or tid not in t.parent:
        return (1, ())
    return (0, tuple(reversed(t.lineage(tid))))


def _header_tid(t: "TaxTree", header: str) -> Optional[int]:
    import re as _re
    m = _re.search(r"(?:tid\||taxid[=| ]|tax_id[=| ]|ncbi\|)(\d+)",
                   header)
    if m:
        return int(m.group(1))
    gi = _parse_gi(header)
    if gi >= 0:
        return None  # gi headers need the table; handled by gi2taxid
    tok = header.split()[0] if header else ""
    return t.name_to_id.get(tok.lower())


def sortbytaxa(argv: List[str]) -> int:
    """reference: sortbytaxa.sh (tax/SortByTaxa.java) — sort sequences
    into taxonomic order (tree path, then taxid, then length desc, then
    name)."""
    args = Args.parse(argv)
    inp = args.get("in")
    out = args.get("out")
    t = _load_tree(args)
    if None in (inp, out) or t is None:
        print("Usage: sortbytaxa in= out= tree=<tree.taxtree.gz|"
              "nodes.dmp> [names=names.dmp]", file=sys.stderr)
        return 1
    recs = list(fastx.read_seqs(inp))
    recs.sort(key=lambda r: (_tax_sort_key(t, _header_tid(t, r.id)),
                             _header_tid(t, r.id) or 0,
                             -len(r.bases), r.id))
    fmt = fastx.sniff_format(out)
    if fmt == "fastq":
        fastx.write_fastq(out, iter(recs))
    else:
        fastx.write_fasta(out, iter(recs))
    return 0


def splitbytaxa(argv: List[str]) -> int:
    """reference: splitbytaxa.sh (tax/SplitByTaxa.java) — split
    sequences into per-taxon files; out= must contain '%' which is
    replaced by the taxon name at the given level (level=phylum
    default)."""
    args = Args.parse(argv)
    inp = args.get("in")
    out = args.get("out")
    level = (args.get("level") or "phylum").lower()
    t = _load_tree(args)
    if None in (inp, out) or t is None:
        print("Usage: splitbytaxa in= out=out_%.fa level=phylum "
              "tree=<tree>", file=sys.stderr)
        return 1
    if "%" not in out:
        print("Output filename must contain % symbol.",
              file=sys.stderr)
        return 1
    groups: Dict[str, List] = {}
    for rec in fastx.read_seqs(inp):
        tid = _header_tid(t, rec.id)
        name = "Unknown"
        if tid is not None:
            for x in t.lineage(tid):
                if t.rank.get(x) == level:
                    name = t.name.get(x, str(x)).replace(" ", "_")
                    break
        groups.setdefault(name, []).append(rec)
    for name, recs in groups.items():
        path = out.replace("%", name)
        fmt = fastx.sniff_format(path)
        if fmt == "fastq":
            fastx.write_fastq(path, iter(recs))
        else:
            fastx.write_fasta(path, iter(recs))
    sys.stderr.write(f"Groups:\t{len(groups)}\n")
    return 0


TOOLS = dict(printtaxonomy=printtaxonomy, findancestor=findancestor,
             filterbytaxa=filterbytaxa)


def main(argv: List[str]) -> int:
    if not argv or argv[0] not in TOOLS:
        print("taxonomy tools: " + ", ".join(TOOLS), file=sys.stderr)
        return 1
    return TOOLS[argv[0]](argv[1:])
