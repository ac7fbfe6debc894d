"""Virtual-process map and thread placement.

Rebuild of the reference's vpmap + hwloc binding pair (reference:
parsec/vpmap.{c,h} — #VPs, threads per VP, core affinities, initialized
from flat/parameters/hardware — and parsec_hwloc.c/bindthread.c thread->
core binding).  A virtual process (VP) groups execution streams that
share a scheduler domain (per-VP queues in llp/ap, NUMA islands in the
reference); on this platform topology discovery is os-level (no hwloc):
``from_hardware`` splits the streams across the machine's cores, and
binding uses ``os.sched_setaffinity`` where the OS provides it.

MCA: ``--mca vpmap flat`` (default, one VP), ``--mca vpmap 2:4`` (2 VPs
x 4 streams), ``--mca vpmap hw``; ``--mca runtime_bind_threads 1`` pins
each worker to a core round-robin.
"""

from __future__ import annotations

import os
from typing import List, Optional

from parsec_tpu_torch.utils.mca import params
from parsec_tpu_torch.utils.output import debug_verbose, warning

params.register("vpmap", "flat",
                "virtual-process map: flat | <nvp>:<threads_per_vp> | hw | file:<path>")
params.register("runtime_bind_threads", 0,
                "bind worker threads to cores round-robin (Linux only)")


def _parse_cpu_list(s: str) -> List[int]:
    """Kernel cpu-list syntax: ``0-3,8,10-11`` -> [0,1,2,3,8,10,11]."""
    out: List[int] = []
    for tok in s.strip().split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "-" in tok:
            lo, _, hi = tok.partition("-")
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(tok))
    return out


def discover_topology(sysfs_root: str = "/sys"):
    """OS-level hardware topology (the hwloc counterpart — reference:
    parsec_hwloc.c builds the socket/cache hierarchy; here the kernel's
    sysfs exports the same facts): reads
    ``cpu*/topology/package_cpus_list`` and
    ``cpu*/cache/index*/{level,type,shared_cpu_list}`` into grouped
    core lists per sharing level.

    Returns ``{"cpus": [ids...], "package": [[cores]...],
    "l3": [...], "l2": [...], "l1": [...]}`` where each level lists
    disjoint groups of cores sharing that resource.  Missing sysfs
    (non-Linux, containers) yields single/empty groups — callers fall
    back to flat splits."""
    base = os.path.join(sysfs_root, "devices/system/cpu")
    cpus: List[int] = []
    try:
        for name in os.listdir(base):
            m = name.startswith("cpu") and name[3:].isdigit()
            if m:
                cpus.append(int(name[3:]))
    except OSError:
        return {"cpus": [], "package": [], "l3": [], "l2": [], "l1": []}
    cpus.sort()

    def read(path: str) -> Optional[str]:
        try:
            with open(path) as fh:
                return fh.read().strip()
        except OSError:
            return None

    def groups_from(keyfn) -> List[List[int]]:
        seen = {}
        for c in cpus:
            key = keyfn(c)
            if key is None:
                key = ("self", c)
            seen.setdefault(key, []).append(c)
        return sorted(seen.values(), key=lambda g: g[0])

    def pkg_key(c: int):
        s = read(f"{base}/cpu{c}/topology/package_cpus_list")
        return tuple(_parse_cpu_list(s)) if s else None

    def cache_key(level: int):
        def key(c: int):
            cdir = f"{base}/cpu{c}/cache"
            try:
                idxs = [n for n in os.listdir(cdir)
                        if n.startswith("index")]
            except OSError:
                return None
            for idx in idxs:
                lv = read(f"{cdir}/{idx}/level")
                ty = read(f"{cdir}/{idx}/type") or ""
                if lv and int(lv) == level and ty != "Instruction":
                    s = read(f"{cdir}/{idx}/shared_cpu_list")
                    if s:
                        return tuple(_parse_cpu_list(s))
            return None
        return key

    return {
        "cpus": cpus,
        "package": groups_from(pkg_key),
        "l3": groups_from(cache_key(3)),
        "l2": groups_from(cache_key(2)),
        "l1": groups_from(cache_key(1)),
    }


class VPMap:
    """Stream -> (vp, core) placement (reference: vpmap.h:45-68)."""

    def __init__(self, nb_threads: int, vp_of: List[int],
                 core_of: Optional[List[Optional[int]]] = None):
        self.nb_threads = nb_threads
        self._vp_of = vp_of
        self._core_of = core_of or [None] * nb_threads
        self.nb_vps = (max(vp_of) + 1) if vp_of else 1

    # -- constructors (reference: vpmap_init_from_*) ----------------------
    @classmethod
    def from_flat(cls, nb_threads: int) -> "VPMap":
        """One VP holding every stream (reference: vpmap_init_from_flat)."""
        return cls(nb_threads, [0] * nb_threads)

    @classmethod
    def from_parameters(cls, spec: str, nb_threads: int) -> "VPMap":
        """``<nvp>:<threads_per_vp>`` (reference:
        vpmap_init_from_parameters)."""
        try:
            nvp_s, tpv_s = spec.split(":")
            nvp, tpv = max(1, int(nvp_s)), max(1, int(tpv_s))
        except ValueError:
            warning("vpmap %r unparseable; falling back to flat", spec)
            return cls.from_flat(nb_threads)
        return cls(nb_threads, [min(i // tpv, nvp - 1)
                                for i in range(nb_threads)])

    @classmethod
    def from_hardware(cls, nb_threads: int,
                      sysfs_root: str = "/sys") -> "VPMap":
        """One VP per hardware locality domain (reference:
        vpmap_init_from_hardware_affinity, parsec_hwloc.c socket/NUMA
        grouping): ``discover_topology`` reads the kernel's cache +
        package hierarchy and the VP groups follow the deepest level
        with real sharing — packages, else shared-LLC islands.  With no
        discoverable structure (1 core, no sysfs) this degenerates to
        contiguous balanced core blocks, the old behavior."""
        topo = discover_topology(sysfs_root)
        groups: List[List[int]] = []
        for lvl in ("package", "l3", "l2"):
            lv = topo.get(lvl) or []
            # a level only structures the machine if it has SEVERAL
            # groups of genuinely shared cores (singleton-per-core
            # levels are no locality signal)
            if len(lv) > 1 and any(len(g) > 1 for g in lv):
                groups = lv
                break
        if len(groups) <= 1:
            ncores = len(topo.get("cpus") or []) or os.cpu_count() or 1
            nvp = max(1, min(nb_threads, ncores))
            return cls(nb_threads,
                       [i * nvp // nb_threads for i in range(nb_threads)],
                       [i % ncores for i in range(nb_threads)])
        # interleave streams across the domains (balanced VPs), binding
        # each to a concrete core of its domain
        order = []
        width = max(len(g) for g in groups)
        for j in range(width):
            for g, cores in enumerate(groups):
                if j < len(cores):
                    order.append((g, cores[j]))
        vp_of, core_of = [], []
        for i in range(nb_threads):
            g, c = order[i % len(order)]
            vp_of.append(g)
            core_of.append(c)
        return cls(nb_threads, vp_of, core_of)

    @classmethod
    def from_file(cls, path: str, nb_threads: int,
                  rank: int = 0) -> "VPMap":
        """Reference vpmap file format (reference: vpmap_init_from_file,
        parsec/vpmap.c:219): one VP per line, ``rank:nbthreads:binding``
        — a leading ':' (no rank) applies to every rank; ``binding`` is
        a comma list of cores with ``a-b`` ranges.  Lines for other
        ranks are skipped.  If the file describes a different thread
        count than ``nb_threads``, the map is clipped/extended
        round-robin with a warning (the reference spawns exactly the
        file's threads; here the context owns the stream count)."""
        vp_of: List[int] = []
        core_of: List[Optional[int]] = []
        try:
            with open(path) as fh:
                lines = fh.readlines()
        except OSError as exc:
            warning("vpmap file %s: %s; falling back to flat", path, exc)
            return cls.from_flat(nb_threads)
        vp = 0
        for line in lines:
            line = line.strip()
            if not line or line.startswith("#") or ":" not in line:
                if line and not line.startswith("#"):
                    warning("vpmap %s: malformed line %r", path, line)
                continue
            rank_s, _, rest = line.partition(":")
            try:
                if rank_s.strip() and int(rank_s) != rank:
                    continue
            except ValueError:
                warning("vpmap %s: malformed line %r", path, line)
                continue
            nbth_s, _, binding = rest.partition(":")
            try:
                nbth = max(1, int(nbth_s))
            except ValueError:
                warning("vpmap %s: malformed line %r", path, line)
                continue
            cores: List[Optional[int]] = []
            try:
                for tok in binding.split(","):
                    tok = tok.strip()
                    if not tok:
                        continue
                    if "-" in tok:
                        lo, _, hi = tok.partition("-")
                        cores.extend(range(int(lo), int(hi) + 1))
                    else:
                        cores.append(int(tok))
            except ValueError:
                warning("vpmap %s: malformed binding %r", path, line)
                cores = []
            for t in range(nbth):
                vp_of.append(vp)
                core_of.append(cores[t % len(cores)] if cores else None)
            vp += 1
        if not vp_of:
            warning("vpmap %s: no VP lines for rank %d; flat map", path,
                    rank)
            return cls.from_flat(nb_threads)
        if len(vp_of) != nb_threads:
            warning("vpmap %s describes %d threads, context runs %d; "
                    "mapping round-robin", path, len(vp_of), nb_threads)
            vp_of = [vp_of[i % len(vp_of)] for i in range(nb_threads)]
            core_of = [core_of[i % len(core_of)]
                       for i in range(nb_threads)]
        return cls(nb_threads, vp_of, core_of)

    @classmethod
    def from_mca(cls, nb_threads: int, rank: int = 0) -> "VPMap":
        spec = str(params.get("vpmap", "flat"))
        if spec == "hw":
            return cls.from_hardware(nb_threads)
        if spec.startswith("file:"):
            return cls.from_file(spec[5:], nb_threads, rank)
        if ":" in spec:
            return cls.from_parameters(spec, nb_threads)
        return cls.from_flat(nb_threads)

    # -- queries (reference: vpmap_get_*) ----------------------------------
    def vp_of(self, th_id: int) -> int:
        return self._vp_of[th_id] if th_id < len(self._vp_of) else 0

    def core_of(self, th_id: int) -> Optional[int]:
        return self._core_of[th_id] if th_id < len(self._core_of) else None

    def threads_of_vp(self, vp: int) -> List[int]:
        return [i for i, v in enumerate(self._vp_of) if v == vp]


def bind_current_thread(core: Optional[int]) -> bool:
    """Pin the calling thread to ``core`` (reference: parsec_bindthread).
    Returns True on success; silently no-ops where unsupported."""
    if core is None or not hasattr(os, "sched_setaffinity"):
        return False
    try:
        os.sched_setaffinity(0, {core})
        debug_verbose(7, "bound thread to core %d", core)
        return True
    except OSError:
        return False
