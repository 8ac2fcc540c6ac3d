"""NCBI taxonomy machinery (`createtaxdb`, `lca`, `taxonomy`, ...).

Reference: lib/mmseqs/src/taxonomy/NcbiTaxonomy.{h,cpp} (dmp parsing,
LCA, rank projections, lineage strings), lca.cpp, addtaxonomy.cpp,
taxonomyreport.cpp, filtertaxdb.cpp (TaxonomyExpression.h) and the
createtaxdb.sh offline path (provided dump dir + accession mapping).
"""
import os

NCBI_RANKS = {
    "forma": 1, "varietas": 2, "subspecies": 3, "species": 4,
    "species subgroup": 5, "species group": 6, "subgenus": 7, "genus": 8,
    "subtribe": 9, "tribe": 10, "subfamily": 11, "family": 12,
    "superfamily": 13, "parvorder": 14, "infraorder": 15, "suborder": 16,
    "order": 17, "superorder": 18, "infraclass": 19, "subclass": 20,
    "class": 21, "superclass": 22, "subphylum": 23, "phylum": 24,
    "superphylum": 25, "subkingdom": 26, "kingdom": 27, "superkingdom": 28,
}  # NcbiTaxonomy.h:57-84

SHORT_RANKS = {"species": "s", "genus": "g", "family": "f", "order": "o",
               "class": "c", "phylum": "p", "kingdom": "k",
               "superkingdom": "d"}  # NcbiTaxonomy.h:86-93

DEFAULT_BLACKLIST = "12908:unclassified sequences,28384:other sequences"


class TaxonNode:
    __slots__ = ("tax_id", "parent_tax_id", "rank", "name")

    def __init__(self, tax_id, parent_tax_id, rank, name):
        self.tax_id = tax_id
        self.parent_tax_id = parent_tax_id
        self.rank = rank
        self.name = name


class Taxonomy:
    """Loaded from <prefix>_nodes.dmp/_names.dmp/_merged.dmp (the layout
    createtaxdb leaves next to a sequence DB, createtaxdb.sh:74-77)."""

    def __init__(self, nodes, merged):
        self.nodes = nodes          # tax_id -> TaxonNode
        self.merged = merged        # old tax_id -> new tax_id
        self._depth = {}

    @classmethod
    def open(cls, prefix):
        """NcbiTaxonomy::openTaxonomy (NcbiTaxonomy.cpp:485-517): prefer
        the binary <prefix>_taxonomy dump, fall back to the dmp files."""
        bin_file = prefix + "_taxonomy"
        if os.path.exists(bin_file):
            with open(bin_file, "rb") as f:
                return unserialize_taxonomy(f.read())
        for suffix in ("_nodes.dmp", "_names.dmp", "_merged.dmp"):
            if not os.path.exists(prefix + suffix):
                raise FileNotFoundError(
                    f"{prefix}{suffix} not found — run createtaxdb first")
        nodes = {}
        with open(prefix + "_nodes.dmp") as f:
            for line in f:
                parts = line.split("\t|\t")
                tax_id = int(parts[0])
                parent = int(parts[1])
                rank = parts[2].strip()
                nodes[tax_id] = TaxonNode(tax_id, parent, rank, "")
        with open(prefix + "_names.dmp") as f:
            for line in f:
                if "scientific name" not in line:
                    continue
                parts = line.split("\t|\t")
                tax_id = int(parts[0])
                if tax_id in nodes:
                    nodes[tax_id].name = parts[1].strip()
        merged = {}
        with open(prefix + "_merged.dmp") as f:
            for line in f:
                parts = line.replace("|", "").split()
                if len(parts) >= 2:
                    merged[int(parts[0])] = int(parts[1])
        return cls(nodes, merged)

    def node(self, tax_id):
        if tax_id in self.nodes:
            return self.nodes[tax_id]
        if tax_id in self.merged:
            return self.nodes.get(self.merged[tax_id])
        return None

    def exists(self, tax_id):
        return self.node(tax_id) is not None

    def _lineage_ids(self, tax_id):
        out = []
        n = self.node(tax_id)
        while n is not None:
            out.append(n.tax_id)
            if n.parent_tax_id == n.tax_id:
                break
            n = self.node(n.parent_tax_id)
        return out

    def is_ancestor(self, ancestor, child):
        if not self.exists(ancestor) or not self.exists(child):
            return False
        return self.node(ancestor).tax_id in self._lineage_ids(child)

    def lca_pair(self, a, b):
        la = self._lineage_ids(a)
        lb = set(self._lineage_ids(b))
        for t in la:
            if t in lb:
                return t
        return 1

    def lca(self, taxa):
        """NcbiTaxonomy::LCA(vector): skip unknown taxa (with the
        reference's 0-absorbs rule in lcaHelper: taxid contributions of 0
        collapse to 0/None)."""
        known = [t for t in taxa if self.exists(t)]
        if not known:
            return None
        red = known[0]
        for t in known[1:]:
            red = self.lca_pair(red, t)
        return self.node(red)

    def all_ranks(self, node):
        """NcbiTaxonomy::AllRanks (NcbiTaxonomy.cpp:411-427)."""
        result = {}
        while True:
            if node.tax_id == 1:
                result.setdefault(node.rank, node.name)
                return result
            if node.rank not in ("no_rank", "no rank"):
                result.setdefault(node.rank, node.name)
            node = self.node(node.parent_tax_id)

    def at_ranks(self, node, levels):
        """NcbiTaxonomy::AtRanks (NcbiTaxonomy.cpp:313-338)."""
        result = []
        ranks = self.all_ranks(node)
        base_rank_index = NCBI_RANKS.get(node.rank, -1)
        base_rank = "uc_" + node.name
        for level in levels:
            if level in ranks:
                result.append(ranks[level])
            elif NCBI_RANKS[level] < base_rank_index:
                result.append(base_rank)
            else:
                result.append("unknown")
        return result

    def tax_lineage(self, node, info_as_name=True):
        """NcbiTaxonomy::taxLineage (NcbiTaxonomy.cpp:367-390)."""
        chain = []
        while True:
            chain.append(node)
            parent = self.node(node.parent_tax_id)
            if parent.parent_tax_id == parent.tax_id:
                break
            node = parent
        parts = []
        for n in reversed(chain):
            if info_as_name:
                parts.append(SHORT_RANKS.get(n.rank, "-") + "_" + n.name)
            else:
                parts.append(str(n.tax_id))
        return ";".join(parts)


SERIALIZATION_VERSION = 2  # NcbiTaxonomy.cpp:17


def _flog2_int(x):
    """(int)MathUtil::flog2(x) (MathUtil.h:107-119): 5th-order polynomial
    log2 approximation, exact at powers of two."""
    from ..native import lib as native_lib
    return int(native_lib().pssm_flog2(float(x)))


def serialize_taxonomy(names_file, nodes_file, merged_file):
    """NcbiTaxonomy(names,nodes,merged) + NcbiTaxonomy::serialize
    (NcbiTaxonomy.cpp:35-77,704-745): build the Euler-tour/RMQ LCA
    structures and the deduplicated StringBlock, then emit the version-2
    binary dump. Struct padding (TaxonNode bytes 12:16) is written as
    zeros; the reference leaves heap garbage there, so comparisons must
    mask those bytes."""
    import struct

    import numpy as np

    # --- loadNodes (NcbiTaxonomy.cpp:110-154): file order defines ids
    tax_ids, parents, rank_strs = [], [], []
    with open(nodes_file, "rb") as f:
        for line in f:
            parts = line.rstrip(b"\n").split(b"\t|\t", 3)
            tax_ids.append(int(parts[0]))
            parents.append(int(parts[1]))
            rank_strs.append(parts[2])
    n = len(tax_ids)
    max_tax_id = max(tax_ids) if n else 0
    node_id = {}
    for i, t in enumerate(tax_ids):
        node_id[t] = i
    D = np.full(max_tax_id + 1, -1, dtype=np.int32)
    for t, i in node_id.items():
        D[t] = i

    # --- StringBlock appends: ranks per node, then scientific names
    appends = list(rank_strs)
    name_idx = [(1 << 64) - 1] * n  # (size_t)-1 for unnamed nodes
    # --- loadMerged (NcbiTaxonomy.cpp:?): D[old] = D[new]
    with open(merged_file, "rb") as f:
        for line in f:
            parts = line.rstrip(b"\n").split(b"\t|\t", 2)
            if len(parts) != 2:
                raise ValueError("Invalid merged.dmp entry")
            old_id = int(parts[0])
            new_id = int(parts[1].split(b"\t")[0])
            if not 0 <= old_id <= max_tax_id:
                continue  # reference reads out of bounds here (UB)
            old_known = D[old_id] >= 0
            if not old_known and 0 <= new_id <= max_tax_id and D[new_id] >= 0:
                D[old_id] = D[new_id]
    # --- loadNames (NcbiTaxonomy.cpp:165-188)
    with open(names_file, "rb") as f:
        for line in f:
            if b"scientific name" not in line:
                continue
            parts = line.split(b"\t|\t", 2)
            t = int(parts[0])
            name_idx[node_id[t]] = len(appends)
            appends.append(parts[1])

    # --- Euler tour elh(children, 1, 0) (NcbiTaxonomy.cpp:191-204)
    children = [[] for _ in range(n)]
    for i in range(n):
        if parents[i] != tax_ids[i]:
            children[node_id[parents[i]]].append(tax_ids[i])
    E, L = [], []
    H = [0] * n
    # iterative replica of the recursion: (id, level, child_pos)
    root = node_id[1]
    stack = [[root, 0, 0]]
    if H[root] == 0:
        H[root] = len(E)
    E.append(root)
    L.append(0)
    while stack:
        nid, level, pos = stack[-1]
        kids = children[nid]
        if pos < len(kids):
            stack[-1][2] += 1
            cid = node_id[kids[pos]]
            if H[cid] == 0:
                H[cid] = len(E)
            E.append(cid)
            L.append(level + 1)
            stack.append([cid, level + 1, 0])
        else:
            E.append(node_id[parents[nid]])
            L.append(level - 1)
            stack.pop()
    E += [0] * (2 * n - len(E))
    L += [0] * (2 * n - len(L))
    E = np.asarray(E, dtype=np.int32)
    L = np.asarray(L, dtype=np.int32)

    # --- RMQ sparse table (NcbiTaxonomy.cpp:206-225)
    dim = 2 * n
    k = _flog2_int(dim) + 1
    M = np.zeros((dim, k), dtype=np.int32)
    M[:, 0] = np.arange(dim, dtype=np.int32)
    j = 1
    while (1 << j) <= dim:
        span = 1 << (j - 1)
        imax = dim - (1 << j) + 1
        A = M[:imax, j - 1]
        B = M[span:span + imax, j - 1]
        M[:imax, j] = np.where(L[A] < L[B], A, B)
        j += 1

    # --- StringBlock::compact + serialize (StringBlock.h:59-118):
    # unique strings laid out in ascending strcmp order
    uniq = sorted(set(appends))
    offset_of = {}
    off = 0
    data_parts = []
    for s in uniq:
        offset_of[s] = off
        data_parts.append(s + b"\0")
        off += len(s) + 1
    block_data = b"".join(data_parts)
    entry_count = len(appends)
    offsets = np.array([offset_of[s] for s in appends], dtype=np.uint32)

    out = bytearray()
    out += struct.pack("<i", SERIALIZATION_VERSION)
    out += struct.pack("<Q", n)
    out += struct.pack("<i", max_tax_id)
    nodes_arr = np.zeros(n, dtype=[("id", "<i4"), ("taxId", "<i4"),
                                   ("parentTaxId", "<i4"), ("pad", "<i4"),
                                   ("rankIdx", "<u8"), ("nameIdx", "<u8")])
    nodes_arr["id"] = np.arange(n, dtype=np.int32)
    nodes_arr["taxId"] = tax_ids
    nodes_arr["parentTaxId"] = parents
    # rankIdx/nameIdx are StringBlock entry indices (append order), not
    # byte offsets; ranks are appended once per node before any name
    nodes_arr["rankIdx"] = np.arange(n, dtype=np.uint64)
    nodes_arr["nameIdx"] = np.array(name_idx, dtype=np.uint64)
    out += nodes_arr.tobytes()
    out += D.tobytes()
    out += E.tobytes()
    out += L.tobytes()
    out += np.asarray(H, dtype=np.int32).tobytes()
    out += np.ascontiguousarray(M).tobytes()
    out += struct.pack("<Q", len(block_data))     # byteCapacity
    out += struct.pack("<I", entry_count)         # entryCapacity
    out += struct.pack("<I", entry_count)         # entryCount
    out += block_data
    out += offsets.tobytes()
    return bytes(out)


def unserialize_taxonomy(mem):
    """NcbiTaxonomy::unserialize (NcbiTaxonomy.cpp:747-779) into the
    dict-based Taxonomy (merged aliases recovered from D entries whose
    node's own taxId differs)."""
    import struct

    import numpy as np

    p = 0
    version = struct.unpack_from("<i", mem, p)[0]
    p += 4
    if version != SERIALIZATION_VERSION:
        raise ValueError("incompatible binary taxonomy version")
    n = struct.unpack_from("<Q", mem, p)[0]
    p += 8
    max_tax_id = struct.unpack_from("<i", mem, p)[0]
    p += 4
    nodes_arr = np.frombuffer(mem, dtype=[
        ("id", "<i4"), ("taxId", "<i4"), ("parentTaxId", "<i4"),
        ("pad", "<i4"), ("rankIdx", "<u8"), ("nameIdx", "<u8")],
        count=n, offset=p)
    p += n * 32
    D = np.frombuffer(mem, dtype="<i4", count=max_tax_id + 1, offset=p)
    p += 4 * (max_tax_id + 1)
    p += 4 * (2 * n)  # E
    p += 4 * (2 * n)  # L
    p += 4 * n        # H
    dim = 2 * n
    k = _flog2_int(dim) + 1
    p += 4 * dim * k  # M
    byte_capacity = struct.unpack_from("<Q", mem, p)[0]
    p += 8
    entry_capacity = struct.unpack_from("<I", mem, p)[0]
    p += 4
    entry_count = struct.unpack_from("<I", mem, p)[0]
    p += 4
    block_data = bytes(mem[p:p + byte_capacity])
    p += byte_capacity
    offsets = np.frombuffer(mem, dtype="<u4", count=entry_capacity,
                            offset=p)

    def get_string(idx):
        if idx >= entry_count:
            return ""
        off = int(offsets[idx])
        end = block_data.index(b"\0", off)
        return block_data[off:end].decode()

    nodes = {}
    for i in range(n):
        t = int(nodes_arr["taxId"][i])
        rank = get_string(int(nodes_arr["rankIdx"][i]))
        nidx = int(nodes_arr["nameIdx"][i])
        name = get_string(nidx) if nidx < entry_count else ""
        nodes[t] = TaxonNode(t, int(nodes_arr["parentTaxId"][i]), rank,
                             name)
    merged = {}
    tax_by_node = nodes_arr["taxId"]
    for t in range(max_tax_id + 1):
        i = int(D[t])
        if i >= 0 and int(tax_by_node[i]) != t:
            merged[t] = int(tax_by_node[i])
    return Taxonomy(nodes, merged)


def read_mapping(path):
    """<db>_mapping: 'key\\ttaxid' per line (Util::readMapping)."""
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out[int(parts[0])] = int(parts[1])
    return out


def write_mapping(path, mapping):
    with open(path, "w") as f:
        for key in sorted(mapping):
            f.write(f"{key}\t{mapping[key]}\n")


def parse_blacklist(tax, blacklist_str):
    out = []
    for item in (blacklist_str or "").split(","):
        item = item.strip()
        if not item:
            continue
        taxon = int(item.split(":")[0])
        if taxon == 0 or not tax.exists(taxon):
            continue
        if ":" in item:
            name = item.split(":", 1)[1]
            node = tax.node(taxon)
            if node is None or node.name != name:
                continue
        out.append(taxon)
    return out


class TaxonomyExpression:
    """TaxonomyExpression.h: comma-separated taxa, '!' negates; a taxon
    matches when it is (not) a descendant of any listed taxon."""

    def __init__(self, expression, tax):
        self.terms = []
        for item in expression.split(","):
            item = item.strip()
            if not item:
                continue
            negate = item.startswith("!")
            self.terms.append((negate, int(item.lstrip("!"))))
        self.tax = tax

    def matches(self, taxon):
        ok = False
        for (negate, anc) in self.terms:
            anc_ok = self.tax.is_ancestor(anc, taxon)
            if negate:
                if anc_ok:
                    return False
                ok = True
            elif anc_ok:
                ok = True
        return ok


MAX_TAX_WEIGHT = 1000.0  # NcbiTaxonomy.h:32

# Parameters.h AGG_TAX_* vote modes
AGG_TAX_UNIFORM = 0
AGG_TAX_MINUS_LOG_EVAL = 1
AGG_TAX_SCORE = 2


def weighted_tax_hit_weight(value, vote_mode):
    """WeightedTaxHit ctor (NcbiTaxonomy.cpp:553-575)."""
    import math
    if vote_mode == AGG_TAX_UNIFORM:
        return 1.0
    if vote_mode == AGG_TAX_MINUS_LOG_EVAL:
        flt_max = 3.4028234663852886e38
        if value != flt_max:
            return -math.log(value) if value > 0 else MAX_TAX_WEIGHT
        return value
    return value  # AGG_TAX_SCORE


def weighted_majority_lca_full(tax, hits, majority_cutoff):
    """NcbiTaxonomy::weightedMajorityLCA (NcbiTaxonomy.cpp:577-680):
    accumulate weights up the lineages; a node is a *candidate* when it
    was hit directly or is reached through two different children
    (TaxNode::update, NcbiTaxonomy.cpp:536-542). Among candidates meeting
    the cutoff, pick the one whose nearest ranked lineage node is deepest;
    ties by higher weight fraction.

    hits: [(taxon, weight)]. Returns
    (taxon, assigned, unassigned, agree, percent) like WeightedTaxResult.
    """
    counts = {}  # taxid -> [weight, is_candidate, child_taxon]
    assigned = 0
    unassigned = 0
    total = 0.0
    for (taxon, weight) in hits:
        if taxon == 0:
            unassigned += 1
            continue
        node = tax.node(taxon)
        if node is None:
            raise ValueError(f"taxonid: {taxon} does not match a legal "
                             "taxonomy node")
        total += weight
        assigned += 1
        cur = node.tax_id
        ent = counts.get(cur)
        if ent is not None:
            if ent[2] != 0:
                ent[1] = True
                ent[2] = 0
            ent[0] += weight
        else:
            counts[cur] = [weight, True, 0]
        parent = node.parent_tax_id
        while parent != cur:
            ent = counts.get(parent)
            if ent is not None:
                if ent[2] != cur:
                    ent[1] = True
                    ent[2] = cur
                ent[0] += weight
            else:
                counts[parent] = [weight, False, cur]
            cur = parent
            parent = tax.node(parent).parent_tax_id
    if total == 0:
        return (0, assigned, unassigned, 0, 0.0)
    selected = 0
    min_rank = (1 << 31) - 1  # ROOT_RANK = INT_MAX
    selected_percent = 0.0
    for taxon in sorted(counts):
        weight, is_cand, _child = counts[taxon]
        if not is_cand:
            continue
        percent = weight / total
        if percent < majority_cutoff:
            continue
        node = tax.node(taxon)
        curr_min_rank = (1 << 31) - 1
        cur, parent = node.tax_id, node.parent_tax_id
        while parent != cur:
            idx = NCBI_RANKS.get(node.rank, -1)
            if idx > 0:
                curr_min_rank = idx
                break
            cur = parent
            node = tax.node(parent)
            parent = node.parent_tax_id
        if (curr_min_rank < min_rank
                or (curr_min_rank == min_rank
                    and percent > selected_percent)):
            selected = taxon
            min_rank = curr_min_rank
            selected_percent = percent
    if selected == 1:  # ROOT_TAXID: all assigned agree
        return (selected, assigned, unassigned, assigned, selected_percent)
    if selected == 0:
        return (selected, assigned, unassigned, 0, selected_percent)
    agree = 0
    for (taxon, _weight) in hits:
        if taxon == 0:
            continue
        node = tax.node(taxon)
        cur, parent = node.tax_id, node.parent_tax_id
        while parent != cur:
            if cur == selected:
                agree += 1
                break
            cur = parent
            parent = tax.node(parent).parent_tax_id
    return (selected, assigned, unassigned, agree, selected_percent)


def weighted_majority_lca(tax, hits, majority_cutoff):
    """Selected-taxid-only wrapper around weighted_majority_lca_full."""
    return weighted_majority_lca_full(tax, hits, majority_cutoff)[0]
