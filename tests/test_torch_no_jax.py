"""The PyTorch port imports neither jax nor the JAX package: the machine
with the GPU has no jax, and importing plass_tpu turns jax on."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, pkgutil, sys
import plass_tpu_torch
names = ["chip_smoke"]
for m in pkgutil.walk_packages(plass_tpu_torch.__path__, "plass_tpu_torch."):
    names.append(m.name)
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "plass_tpu"
             or m.startswith("plass_tpu."))
print(len(names), "modules")
print("BAD", bad)
print("HAVE", sorted(n for n in names if n in sys.modules))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert int(lines[0].split()[0]) >= 70, lines
    assert lines[1] == "BAD []", lines
    # the guided slice's modules, the aligner's, the search slice's, the
    # profile slice's, the linsearch / multi-hit slice's, the taxonomy
    # slice's, the DB tools' and the sharded matcher's are among those
    # imported
    for name in ("workflow.guided", "workflow.linclust", "ops.kmermatch",
                 "ops.ksw2", "ops.nucl_align", "ops.proteinaln2nucl",
                 "assembler.guided_extend", "assembler.cluster",
                 "assembler.cyclecheck", "cli.penguin", "cli.plass",
                 "cli.app", "cli.params", "ops.protein_align",
                 "ops.device_align", "ops.prefilter", "ops.tantan",
                 "data.headers", "data.dbtools", "utils.expr",
                 "workflow.search", "workflow.cluster", "cli.tools",
                 "cli.tools_profile", "ops.profile_query", "ops.profiledb",
                 "ops.msa", "ops.profilestates", "data.ca3m",
                 "ops.linsearch", "ops.alignbykmer", "data.offsetaln",
                 "data.multihit", "cli.tools_db", "cli.tools_misc",
                 "cli.tools_linsearch", "data.taxonomy", "cli.tools_domain",
                 "cli.tools_databases", "data.summarize", "utils.zstd",
                 "parallel", "parallel.distributed", "parallel.mesh"):
        assert f"'plass_tpu_torch.{name}'" in lines[2], name
