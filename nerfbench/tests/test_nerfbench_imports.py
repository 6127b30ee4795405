"""What the runner and the reference load: never JAX or the JAX package
(compared by whole top-level names), and the reference nothing of the
system under test."""

import ast
import json
import subprocess
import sys

from nerfbench import spec

BANNED = {"jax", "jaxlib", "flax", "nerfsr_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": "/nonexistent"}, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_runner_loads_no_jax():
    tops = _loaded(
        "import nerfbench.run, nerfbench.control\n"
        "from nerfbench import spec\n"
        "for w in spec.benchmark()['workloads']:\n"
        "    c = spec.Cell(w['name']); c.driver()\n"
        "    [spec.metric(m['name']) for m in c.per_layer]\n"
        "import nerfsr_torch.engine, nerfsr_torch.models\n"
        "import nerfsr_torch.data.views, nerfsr_torch.data.synthetic\n")
    assert "nerfsr_torch" in tops
    assert not tops & BANNED, tops & BANNED


def test_the_reference_loads_nothing_of_the_system():
    tops = _loaded("import nerfbench.reference.nerf, "
                   "nerfbench.reference.lanczos, "
                   "nerfbench.reference.blender, "
                   "nerfbench.reference.refine")
    assert not tops & (BANNED | {"nerfsr_torch"})
    for path in (spec.ROOT / "nerfbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in BANNED | {"nerfsr_torch"}, \
                    (path.name, n)
