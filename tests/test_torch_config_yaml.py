"""The port's YAML reader and config builders against PyYAML and the JAX
package, on the CPU.

``config.py::load_yaml`` is the port's own reader (it runs where PyYAML
is not installed): it must give what ``yaml.safe_load`` gives, values and
Python types alike, on the shipped configs and on a snippet of each
construct of its subset, YAML 1.1's scalar resolution included;
everything outside the subset (the number forms beyond plain decimals
among them) raises ValueError naming its line. ``dump_yaml`` writes text
both readers read back to the same dict. The dict builders are held to JAX's
field by field.
"""
import dataclasses
import math
from pathlib import Path

import pytest
import yaml

from fluidnet_cxx_tpu import config as j_config
from fluidnet_cxx_tpu_torch import config as t_config

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted(str(p.relative_to(ROOT))
                 for p in (ROOT / "configs").glob("*.yaml"))


def same(a, b):
    """Equal values of equal Python types, NaN equal to NaN."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def test_three_shipped_configs():
    assert CONFIGS == ["configs/plume.yaml", "configs/rayleighTaylor.yaml",
                       "configs/train.yaml"]


@pytest.mark.parametrize("path", CONFIGS)
def test_load_yaml_equals_safe_load(path):
    got = t_config.load_yaml(str(ROOT / path))
    with open(ROOT / path) as f:
        want = yaml.safe_load(f)
    assert same(got, want), (got, want)


# One snippet per construct of the subset; the scalars as PyYAML resolves
# them (YAML 1.1).
SNIPPETS = {
    "block map two deep": "a:\n  b:\n    c: 1\n  d: 2\ne: 3",
    "indented document": "  a: 1\n  b:\n      c: 2",
    "flow map": "gravityVec: {x: 0.0, y: -1.0, z: 0.0}",
    "flow list": "longTermDivNumSteps: [4, 16]",
    "nested flow": "a: {x: [1, {y: 2}], z: []}",
    "empty flow": "a: {}\nb: [ ]",
    "flow trailing comma": "a: [1, 2,]\nb: {c: 1,}",
    "flow empty value": "a: {x: , y: 1}",
    "flow plain with spaces": "a: [a b, c]",
    "comments": "# head\na: 1  # after\n  # indented\nb: x#y\nc: 'q # r'",
    "dash key": "periodic-y: true\nperiodic-x: false",
    "float with dot and signed exponent": "a: 5.0e-5\nb: 1.0e-05\nc: 1.5E+3",
    "exponent without dot is a string": "a: 1e-5",
    "exponent without sign is a string": "a: 1.0e5\nb: 3e5",
    "float forms": "a: 0.0\nb: -0.01\nc: .5\nd: 1.\ne: +2.5\nf: -.5",
    "inf and nan": "a: inf\nb: -inf\nc: nan\nd: '.inf'",
    "int forms": "a: 0\nb: 12\nc: -0\nf: +3\ng: 08",
    "sexagesimal": "a: '1:30'\nb: 1:3x\nc: 1:60",
    "not octal in 1.1": "a: 0o7\nb: 08",
    "booleans": ("a: true\nb: False\nc: YES\nd: no\ne: On\nf: off\ng: TRUE"
                 "\nh: y\ni: n"),
    "nulls": "a: ~\nb: null\nc: Null\nd: NULL\ne:\nf: ''",
    "int 0 and float 0.0": "a: 0\nb: 0.0",
    "quoted": ("a: 'it s'\nb: \"it's\"\nc: '1e-5'\nd: 'x: y'"
               "\ne: 'back\\slash'"),
    "scalar keys": "'1': a\n\"yes\": b\n'2.5': c\nd: 3",
    "colon inside plain": "a: b:c\nurl: http://x/y",
    "duplicate key keeps the last": "a: 1\na: 2",
}


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_snippet_equals_safe_load(name):
    text = SNIPPETS[name]
    got = t_config.parse_yaml(text)
    want = yaml.safe_load(text)
    assert same(got, want), (got, want)


# Outside the subset: each raises ValueError naming its line.
OUTSIDE = {
    "anchor": ("a: 1\nb: &x 2", 2),
    "alias": ("a: 1\nb: *x", 2),
    "tag": ("a: !!str 1", 1),
    "block scalar": ("a: 1\nb: |\n  text", 2),
    "folded scalar": ("a: >\n  text", 1),
    "block list": ("a:\n  - 1\n  - 2", 2),
    "top-level list": ("- 1", 1),
    "document marker": ("a: 1\n---\nb: 2", 2),
    "directive": ("%YAML 1.1\na: 1", 1),
    "multi-line plain": ("a: b\n  c", 2),
    "multi-line quoted": ("a: 'x\n  y'", 1),
    "multi-line flow": ("a: [1,\n  2]", 1),
    "scalar document": ("just text", 1),
    "timestamp": ("a: 1\nb: 2001-01-01", 2),
    "flow entry without ': '": ("a: {x:1}", 1),
    "complex key": ("? a\n: b", 1),
    "mapping in a value": ("a: b: c", 1),
    "tab indentation": ("a:\n\tb: 1", 2),
    "dedent below the document": ("  a: 1\nb: 2", 2),
    "hex int": ("a: 1\nb: 0x1F", 2),
    "octal int": ("a: 07", 1),
    "binary int": ("a: -0b101", 1),
    "zeros": ("a: 00", 1),
    "underscores": ("a: 1\nb: 1_000\nc: 1_0.5", 2),
    "sexagesimal number": ("a: 1:30", 1),
    "sexagesimal float": ("a: 1:30.5", 1),
    "inf": ("a: 1\nb: -.Inf", 2),
    "nan": ("a: .NaN", 1),
    "escape in double quotes": ('a: "a\\tb"', 1),
    "quote doubled in single quotes": ("a: 'it''s'", 1),
    "int key": ("a: 1\n1: b", 2),
    "bool key": ("yes: b", 1),
    "null key in a flow map": ("a: {~: 1}", 1),
}


@pytest.mark.parametrize("name", sorted(OUTSIDE))
def test_outside_the_subset_raises_naming_the_line(name):
    text, line = OUTSIDE[name]
    with pytest.raises(ValueError, match=f"line {line}:"):
        t_config.parse_yaml(text)


def test_empty_document_is_none():
    assert t_config.parse_yaml("") is None
    assert t_config.parse_yaml("# only a comment\n\n") is None
    assert yaml.safe_load("# only a comment\n\n") is None


@pytest.mark.parametrize("path", CONFIGS)
def test_dump_yaml_round_trips(path, tmp_path):
    conf = t_config.load_yaml(str(ROOT / path))
    out = tmp_path / "dumped.yaml"
    text = t_config.dump_yaml(conf, str(out))
    assert out.read_text() == text
    assert same(t_config.load_yaml(str(out)), conf)
    assert same(yaml.safe_load(text), conf)


def test_dump_yaml_quotes_what_would_read_back_otherwise():
    conf = {"s": ["1e-5", "true", "null", "", "a: b", "#c", "it's", "07",
                  " pad", "plain text", "-x", "1_000", "0x1F", ".inf",
                  "1:30", "back\\slash", "'1'"],
            "f": [5e-05, 1e20, -0.0, 3.0], "n": None,
            "nested": {"deep": {"k": [1, {"x": 2}]}, "empty": {}},
            "yes": "a key that reads as a bool unquoted"}
    text = t_config.dump_yaml(conf)
    assert same(t_config.parse_yaml(text), conf)
    assert same(yaml.safe_load(text), conf)
    for bad, what in [({"a": "x\ny"}, "multi-line"),
                      ({"a": math.inf}, "float inf"),
                      ({"a": [math.nan]}, "float nan"),
                      ({3: "x"}, "not a string"),
                      ({"a": {True: 1}}, "not a string"),
                      ({"a": "'q' \"r\""}, "needs escapes")]:
        with pytest.raises(ValueError, match=what):
            t_config.dump_yaml(bad)


def _fields(cfg):
    return {f.name for f in dataclasses.fields(cfg)}


# Fields that only one package's dataclass has (none today): the test
# fails when a field is added on one side only.
ONLY_JAX = {"SimConfig": set(), "ModelConfig": set(), "TrainConfig": set()}
ONLY_PORT = {"SimConfig": set(), "ModelConfig": set(), "TrainConfig": set()}


def _held_equal(got, want):
    name = type(want).__name__
    assert _fields(want) - _fields(got) == ONLY_JAX[name]
    assert _fields(got) - _fields(want) == ONLY_PORT[name]
    for f in sorted(_fields(got) & _fields(want)):
        g, w = getattr(got, f), getattr(want, f)
        assert type(g) is type(w) and g == w, (name, f, g, w)


def _confs():
    out = {"{}": {}}
    for path in CONFIGS:
        with open(ROOT / path) as f:
            out[path] = yaml.safe_load(f)
    return out


@pytest.mark.parametrize("name", ["{}"] + CONFIGS)
def test_builders_equal_jax(name):
    conf = _confs()[name]
    mconf = conf.get("modelParam") or conf
    _held_equal(t_config.sim_config_from_mconf(mconf),
                j_config.sim_config_from_mconf(mconf))
    _held_equal(t_config.model_config_from_mconf(mconf),
                j_config.model_config_from_mconf(mconf))
    _held_equal(t_config.train_config_from_yaml(conf),
                j_config.train_config_from_yaml(conf))


def test_builders_of_an_empty_config_are_the_defaults():
    assert t_config.sim_config_from_mconf({}) == t_config.SimConfig()
    assert t_config.model_config_from_mconf({}) == t_config.ModelConfig()
    assert t_config.train_config_from_yaml({}) == t_config.TrainConfig()


def test_merge_cli_overrides_and_json_configs(tmp_path):
    conf = {"a": 1, "b": 2}
    over = {"b": 3, "c": None, "d": "x"}
    assert (t_config.merge_cli_overrides(conf, over)
            == j_config.merge_cli_overrides(conf, over)
            == {"a": 1, "b": 3, "d": "x"})
    # The model's JSON config, built from the YAML, reads back the same.
    mconf = t_config.load_yaml("configs/train.yaml")["modelParam"]
    mcfg = t_config.model_config_from_mconf(mconf)
    t_config.save_model_config(str(tmp_path / "m"), mcfg)
    assert t_config.load_model_config(str(tmp_path / "m")) == mcfg
