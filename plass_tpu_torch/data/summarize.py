"""Header summarizers (reference: lib/mmseqs/src/commons/HeaderSummarizer.cpp)
and a faithful replica of libstdc++ std::make_heap so the Members= order of
the summarized headers matches the reference byte-for-byte (the reference
iterates the heap ARRAY order after make_heap, not a sorted order).
"""
import re


def _adjust_heap(a, hole, length, value, less):
    """libstdc++ __adjust_heap + trailing __push_heap."""
    top = hole
    second = hole
    while second < (length - 1) // 2:
        second = 2 * (second + 1)
        if less(a[second], a[second - 1]):
            second -= 1
        a[hole] = a[second]
        hole = second
    if (length & 1) == 0 and second == (length - 2) // 2:
        second = 2 * (second + 1)
        a[hole] = a[second - 1]
        hole = second - 1
    # __push_heap
    parent = (hole - 1) // 2
    while hole > top and less(a[parent], value):
        a[hole] = a[parent]
        hole = parent
        parent = (hole - 1) // 2
    a[hole] = value


def make_heap(a, less):
    """libstdc++ std::make_heap array order."""
    length = len(a)
    if length < 2:
        return a
    parent = (length - 2) // 2
    while True:
        value = a[parent]
        _adjust_heap(a, parent, length, value, less)
        if parent == 0:
            return a
        parent -= 1


_UNINFORMATIVE = re.compile(
    "hypothetical|unknown|putative|predicted|unnamed|probable|partial|"
    "possible|uncharacterized|fragment")


def summarize_metaclust(headers, summary_prefix, representative_line):
    """MetaclustHeaderSummarizer::summarize (HeaderSummarizer.cpp:56-140)."""
    queue = []
    rep_identifier = ""
    for i, header in enumerate(headers):
        db_type = "UPI" if "UPI" in header else "lessImportant"
        end = header.find(" ")
        if end == -1:
            continue
        identifier = header[:end]
        if i == 0:
            rep_identifier = identifier
        priority = 4 if db_type == "UPI" else 1
        queue.append((priority, identifier))
    make_heap(queue, lambda x, y: x[0] < y[0])
    members = [ident for _, ident in queue if ident != rep_identifier]
    # a trailing comma (last queue element == representative) is rewritten
    # to the newline by the reference (HeaderSummarizer.cpp:134-139), which
    # collapses to a plain join in both cases
    body = (f"Representative={rep_identifier} n={len(headers)} Members="
            + ",".join(members) + "\n")
    return f"{summary_prefix}-{representative_line}|{body}"


def summarize_uniprot(headers, summary_prefix, representative_line):
    """UniprotHeaderSummarizer::summarize (HeaderSummarizer.cpp:86-150);
    priority arithmetic keeps the reference's unsigned underflow when
    PE > existence 5 is absent (HeaderSummarizer.cpp:35-49)."""
    queue = []
    rep_identifier = ""
    for i, header in enumerate(headers):
        end = header.find("|")
        if end == -1:
            continue
        db_type = header[:end]
        start = end + 1
        end = header.find("|", start)
        if end == -1:
            continue
        identifier = header[start:end]
        if i == 0:
            rep_identifier = identifier
        start = header.find(" ", end)
        if start == -1:
            continue
        start += 1
        end = header.find(" OS=", start)
        if end == -1:
            continue
        protein_name = header[start:end]
        start = header.find("=", end)
        if start == -1:
            continue
        start += 1
        end = header.find(" GN=", start)
        if end == -1:
            end = header.find(" PE=", start)
            if end == -1:
                continue
        organism = header[start:end]
        start = header.find("PE=", end)
        if start == -1:
            continue
        start += 3
        end = header.find(" SV=", start)
        if end == -1:
            continue
        existence = int(header[start:end] or 0)
        priority = 0
        if not _UNINFORMATIVE.search(identifier):
            if db_type == "sp":
                priority = 4
            elif db_type == "tr":
                priority = 1
            # unsigned int wraparound replicated
            priority = (priority + min(existence, 5) - 5) % (1 << 32)
        queue.append((priority, identifier, protein_name, organism))
    make_heap(queue, lambda x, y: x[0] < y[0])
    out = [f"Representative={rep_identifier} n={len(headers)}"]
    used = set()
    descs = []
    count = 0
    parts = []
    for j, (_, ident, pname, _org) in enumerate(queue):
        if count > 5:
            break
        if pname in used:
            continue
        parts.append(pname)
        used.add(pname)
        count += 1
        if j != len(queue) - 1 and count <= 5:
            parts.append("|")
    descs = "".join(parts)
    out.append(f" Descriptions=[{descs}]")
    out.append(" Members=" + ",".join(ident for _, ident, _p, _o in queue))
    return f"{summary_prefix}-{representative_line}|{''.join(out)}\n"
