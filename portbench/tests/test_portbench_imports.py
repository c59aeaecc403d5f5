"""Nothing the benchmark runs loads JAX or the JAX package: the harness's
imports, the program's modules it drives and every metric reader, in a
fresh process, by whole top-level module names (`flac_tpu_torch` is not
`flac_tpu`)."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = """
import json, sys
sys.path.insert(0, sys.argv[1])
from portbench import cells, harness, reference, trace, traffic, work
import portbench.run
from flac_tpu_torch import encoder, kernels, native, config
bench = json.load(open(sys.argv[1] + "/BENCHMARK.json"))
for m in bench["per_layer"]:
    cells.reader(m["name"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT)],
                         capture_output=True, text=True, check=True,
                         timeout=300)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "flac_tpu_torch" in top and "portbench" in top
    assert not top & {"jax", "jaxlib", "flax", "flac_tpu"}
    assert not {"bench"} & top


def test_the_harness_names_the_forbidden_modules_whole():
    from portbench import harness
    assert "flac_tpu" in harness.FORBIDDEN
    assert "flac_tpu_torch" not in harness.forbidden_modules()
