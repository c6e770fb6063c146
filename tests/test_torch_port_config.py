"""The port's config system (cpd_tpu_torch.config, utils.yaml_subset)
against the JAX package's and PyYAML, on the CPU.

The reader must return what ``yaml.safe_load`` returns on every shipped
yaml, types included (``True`` is not ``1``), and raise with the line number
on constructs outside its subset; ``cfg_from_yaml_file`` must give the JAX
package's tree for every model yaml; ``cfg_from_list`` must override as the
JAX package does."""
import math
from pathlib import Path

import pytest
import yaml

from cpd_tpu import config as jconfig
from cpd_tpu_torch import config
from cpd_tpu_torch.utils import yaml_subset

REPO = Path(__file__).resolve().parents[1]
SHIPPED = sorted(str(p.relative_to(REPO)) for p in (REPO / "tools" / "cfgs").rglob("*.yaml"))
MODELS = [p for p in SHIPPED if p.startswith("tools/cfgs/models/")]


def assert_same(port, ref, path="$"):
    """Equal values of the same types, key order included."""
    assert type(port) is type(ref), f"{path}: {type(port).__name__} vs {type(ref).__name__}"
    if isinstance(ref, dict):
        assert list(port) == list(ref), f"{path}: keys {list(port)} vs {list(ref)}"
        for k in ref:
            assert_same(port[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert len(port) == len(ref), f"{path}: length {len(port)} vs {len(ref)}"
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_same(a, b, f"{path}[{i}]")
    elif isinstance(ref, float) and math.isnan(ref):
        assert math.isnan(port), path
    else:
        assert port == ref, f"{path}: {port!r} vs {ref!r}"


def test_nine_shipped_yamls():
    assert len(SHIPPED) == 9 and len(MODELS) == 5


@pytest.mark.parametrize("path", SHIPPED)
def test_reader_equals_safe_load_on_shipped_yaml(path):
    text = (REPO / path).read_text()
    assert_same(yaml_subset.load(text), yaml.safe_load(text))


SCALARS = """\
hex: 0x1F
octal: 010
underscored: 1_000
sexagesimal: 1:30
leading_dot: .5
exponent: 1.0e-5
no_dot_exponent: 1e-5
neg_inf: -.inf
nan: .nan
yes_word: yes
off_word: Off
tilde: ~
empty:
signed: +12
binary: 0b101
plain with spaces: a, b [c] + d
quoted: 'it''s # not a comment'
double: "x: y"
key: value # a comment
flow: [a, [b, {c: d, 'e': ~}], {}, -1, 2.5, true]
'1': one
2: two
list:
- a
-
  - b
- k: v
  w: [1]
"""


def test_reader_equals_safe_load_on_scalars_and_nesting():
    assert_same(yaml_subset.load(SCALARS), yaml.safe_load(SCALARS))


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: &x 2\n", 2), ("a: *x\n", 1), ("a: !!str 1\n", 1), ("a: |\n  text\n", 1),
    ("a: >\n  text\n", 1), ("---\na: 1\n", 1), ("%YAML 1.1\na: 1\n", 1),
    ("a: [1,\n  2]\n", 1), ("a:\n\tb: 1\n", 2), ("? a\n: b\n", 1), ("a: b: c\n", 1),
    ("a: 1\n  b: 2\n", 2), ("a: \"esc\\n\"\n", 1), ("a: 'open\n", 1)],
    ids=["anchor", "alias", "tag", "literal", "folded", "document", "directive",
         "multiline-flow", "tab", "complex-key", "nested-colon", "indent", "escape",
         "unterminated"])
def test_reader_raises_outside_the_subset(text, line):
    with pytest.raises(yaml_subset.YAMLSubsetError) as err:
        yaml_subset.load(text)
    assert err.value.lineno == line and f"line {line}:" in str(err.value)


@pytest.mark.parametrize("path", MODELS)
def test_cfg_from_yaml_file_equals_jax(path):
    port = config.cfg_from_yaml_file(path, config.ConfigDict())
    ref = jconfig.cfg_from_yaml_file(path, jconfig.ConfigDict())
    assert_same(port.to_dict(), ref.to_dict())
    assert port.TAG == ref.TAG and port.EXP_GROUP_PATH == ref.EXP_GROUP_PATH


def _both(fn):
    return fn(config), fn(jconfig)


def test_yaml_inheritance_equals_jax(tmp_path):
    base = tmp_path / "base.yaml"
    base.write_text(yaml.safe_dump({"DATASET": "WaymoUnsupervisedDataset",
                                    "POINT_CLOUD_RANGE": [-75.2, -75.2, -2, 75.2, 75.2, 4],
                                    "NESTED": {"A": 1, "B": 2}}))
    child = tmp_path / "child.yaml"
    child.write_text(yaml.safe_dump({"_BASE_CONFIG_": str(base), "NESTED": {"B": 3, "C": 4},
                                     "EXTRA": True}))
    port, ref = _both(lambda m: m.cfg_from_yaml_file(str(child), m.ConfigDict()))
    assert_same(port.to_dict(), ref.to_dict())
    assert port.NESTED.C == 4 and port.EXTRA is True and port.TAG == "child"


@pytest.mark.parametrize("overrides", [
    ["MODEL.LR", "0.001", "EPOCHS", "5", "MODEL.NEW.DEEP", "[1,2]"],
    ["MODEL.LR", "1", "MODEL.NAME", "CenterPoint", "DATA.PATH", "/tmp/x y"],
    ["MODEL.FLAGS", "{'a': True}", "MODEL.NEW", "None", "EPOCHS", "7"]])
def test_cfg_from_list_equals_jax(overrides):
    def run(m):
        cfg = m.ConfigDict({"MODEL": {"NAME": "VoxelRCNN", "LR": 0.003}, "EPOCHS": 20})
        return m.cfg_from_list(overrides, cfg)
    port, ref = _both(run)
    assert_same(port.to_dict(), ref.to_dict())


@pytest.mark.parametrize("overrides", [["EPOCHS", "five"], ["EPOCHS"]],
                         ids=["type-mismatch", "odd-length"])
def test_cfg_from_list_refuses_what_jax_refuses(overrides):
    for m in (config, jconfig):
        cfg = m.ConfigDict({"EPOCHS": 20})
        with pytest.raises((AssertionError, ValueError)):
            m.cfg_from_list(overrides, cfg)


def test_attribute_write_and_to_dict():
    cfg = config.ConfigDict()
    cfg.A = {"B": [{"C": 1}]}
    assert cfg.A.B[0].C == 1
    assert cfg.to_dict() == {"A": {"B": [{"C": 1}]}}
    assert type(cfg.to_dict()["A"]["B"][0]) is dict
