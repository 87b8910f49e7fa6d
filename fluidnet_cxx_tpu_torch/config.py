"""Simulation, model and training configuration.

``SimConfig``, ``ModelConfig`` and ``TrainConfig`` keep the field names and
defaults of the JAX package's ``config.py`` so a configuration reads the
same in both; ``TrainConfig``'s defaults are ``configs/train.yaml``'s
values. ``sim_config_from_mconf``, ``model_config_from_mconf`` and
``train_config_from_yaml`` build them from the reference's YAML keys, as
the JAX builders do.

``load_yaml`` reads YAML with a reader of its own, never PyYAML, so it
runs where PyYAML is not installed: the subset the shipped
``configs/*.yaml`` use (block mappings, flow mappings and lists, comments,
plain and quoted scalars, string keys). Its plain scalars resolve as
PyYAML's ``safe_load`` resolves them (YAML 1.1): decimal ints, floats with
a dot and a signed exponent (``5.0e-5`` is a float but ``1e-5`` a
string), booleans (``on``/``off`` and ``yes``/``no`` too) and nulls. The
scalars PyYAML reads in other forms (hex, octal, binary or sexagesimal
numbers, underscores, ``.inf``/``.nan``, timestamps), quoted strings with
escapes, and anything else outside the subset raise ValueError naming the
line. ``dump_yaml`` writes the same subset.
"""
import dataclasses
import json
import math
import os
import re
from typing import Any, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Physics/step parameters."""
    dt: float = 0.1
    maccormack_strength: float = 0.6
    sample_outside_fluid: bool = False
    buoyancy_scale: float = 0.0
    gravity_scale: float = 0.0
    gravity_vec: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    operating_density: float = 0.0
    viscosity: float = 0.0
    vorticity_confinement: float = 0.0
    correct_scalar: bool = False
    p_tol: float = 0.0
    jacobi_iter: int = 34
    periodic_x: bool = False
    periodic_y: bool = False
    periodic_z: bool = False
    advection_method: str = "maccormackFluidNet"
    sim_method: str = "jacobi"
    mg_vcycles: int = 2
    mg_pre: int = 4
    mg_post: int = 4
    mg_coarse_iters: int = 32
    mg_warm_start: bool = True
    mg_max_levels3: int = 3
    mg_post3: int = 8
    advection_impl: str = "window"
    max_disp: int = 4
    advect_density: bool = True
    line_trace: bool = True
    line_trace_impl: str = "march"
    use_pallas: bool = False
    fuse_advection: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Network architecture parameters."""
    model: str = "FluidNet"
    input_div: bool = True
    input_p_div: bool = False
    input_u_div: bool = False
    normalize_input: bool = True
    normalize_input_chan: str = "UDiv"
    normalize_input_threshold: float = 1e-5
    dropout: bool = False
    compute_dtype: str = "float32"
    punet_patch: int = 8
    punet_widths: Tuple[int, ...] = (128, 128)
    punet_level_convs: int = 1
    punet_bottleneck_convs: int = 3
    punet_bottleneck_dilation: int = 1
    punet_refine_ch: int = 8
    punet_refine_convs: int = 0
    polish_sweeps: int = 0
    polish_impl: str = "xla"
    polish_damping: float = 2.0 / 3.0

    @property
    def in_dims(self) -> int:
        n = 1
        if self.input_p_div:
            n += 1
        elif self.input_u_div:
            n += 2
        elif self.input_div:
            n += 1
        return n


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop parameters: the 5-term loss's weights, the long-term
    rollout's randomised physics and the plateau scheduler."""
    batch_size: int = 64
    max_epochs: int = 400
    lr: float = 5e-5
    p_l2_lambda: float = 0.0
    div_l2_lambda: float = 1.0
    p_l1_lambda: float = 0.0
    div_l1_lambda: float = 0.0
    div_lt_lambda: float = 1.0
    lt_num_steps: Tuple[int, int] = (4, 16)
    lt_probability: float = 0.9
    train_buoyancy_scale: float = 2.0
    train_buoyancy_prob: float = 0.3
    train_gravity_scale: float = 0.0
    train_gravity_prob: float = 0.0
    time_scale_sigma: float = 1.0
    plateau_factor: float = 0.6
    plateau_patience: int = 10
    plateau_threshold: float = 3e-4


def save_model_config(model_dir: str, cfg: ModelConfig):
    """Write ``<model_dir>/model_config.json`` in the JAX trainer's layout
    (the dataclass's fields, indent 2)."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "model_config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)


def load_model_config(model_dir: str) -> ModelConfig:
    """Read ``<model_dir>/model_config.json`` (the file the JAX trainer
    writes beside its checkpoints). JSON lists come back as tuples."""
    with open(os.path.join(model_dir, "model_config.json")) as f:
        d = json.load(f)
    d = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    return ModelConfig(**d)


def save_config(conf, path: str):
    """Write a config dict as JSON (indent 2; what JSON cannot hold as
    its string)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(conf, f, indent=2, default=str)


def load_config(path: str):
    """A config dict from a ``save_config`` JSON file."""
    with open(path) as f:
        return json.load(f)


def _g(d: Dict[str, Any], key: str, default):
    return d[key] if key in d and d[key] is not None else default


def sim_config_from_mconf(mconf: Dict[str, Any]) -> SimConfig:
    """Build a SimConfig from a reference-convention mconf dict."""
    gv = _g(mconf, "gravityVec", {"x": 0.0, "y": 0.0, "z": 0.0})
    return SimConfig(
        dt=float(_g(mconf, "dt", 0.1)),
        maccormack_strength=float(_g(mconf, "maccormackStrength", 0.6)),
        sample_outside_fluid=bool(_g(mconf, "sampleOutsideFluid", False)),
        buoyancy_scale=float(_g(mconf, "buoyancyScale", 0.0)),
        gravity_scale=float(_g(mconf, "gravityScale", 0.0)),
        gravity_vec=(float(gv["x"]), float(gv["y"]), float(gv["z"])),
        operating_density=float(_g(mconf, "operatingDensity", 0.0)),
        viscosity=float(_g(mconf, "viscosity", 0.0)),
        correct_scalar=bool(_g(mconf, "correctScalar", False)),
        p_tol=float(_g(mconf, "pTol", 0.0)),
        jacobi_iter=int(_g(mconf, "jacobiIter", 34)),
        periodic_x=bool(_g(mconf, "periodic-x", False)),
        periodic_y=bool(_g(mconf, "periodic-y", False)),
        periodic_z=bool(_g(mconf, "periodic-z", False)),
        advection_method=str(
            _g(mconf, "advectionMethod", "maccormackFluidNet")),
        vorticity_confinement=float(_g(mconf, "vorticityConfinement", 0.0)),
        sim_method=str(_g(mconf, "simMethod", "jacobi")),
        fuse_advection=bool(
            _g(mconf, "fuseAdvection", SimConfig.fuse_advection)),
    )


def model_config_from_mconf(mconf: Dict[str, Any]) -> ModelConfig:
    ic = _g(mconf, "inputChannels", {})
    defaults = ModelConfig()
    return ModelConfig(
        model=str(_g(mconf, "model", "FluidNet")),
        input_div=bool(_g(ic, "div", True)),
        input_p_div=bool(_g(ic, "pDiv", False)),
        input_u_div=bool(_g(ic, "UDiv", False)),
        normalize_input=bool(_g(mconf, "normalizeInput", True)),
        normalize_input_chan=str(_g(mconf, "normalizeInputChan", "UDiv")),
        normalize_input_threshold=float(
            _g(mconf, "normalizeInputThreshold", 1e-5)),
        compute_dtype=str(_g(mconf, "computeDtype", defaults.compute_dtype)),
        punet_patch=int(_g(mconf, "punetPatch", defaults.punet_patch)),
        punet_widths=tuple(
            int(x) for x in _g(mconf, "punetWidths", defaults.punet_widths)),
        punet_level_convs=int(
            _g(mconf, "punetLevelConvs", defaults.punet_level_convs)),
        punet_bottleneck_convs=int(
            _g(mconf, "punetBottleneckConvs",
               defaults.punet_bottleneck_convs)),
        punet_bottleneck_dilation=int(
            _g(mconf, "punetBottleneckDilation",
               defaults.punet_bottleneck_dilation)),
        punet_refine_ch=int(
            _g(mconf, "punetRefineCh", defaults.punet_refine_ch)),
        punet_refine_convs=int(
            _g(mconf, "punetRefineConvs", defaults.punet_refine_convs)),
        polish_sweeps=int(_g(mconf, "polishSweeps", defaults.polish_sweeps)),
        polish_damping=float(
            _g(mconf, "polishDamping", defaults.polish_damping)),
        polish_impl=str(_g(mconf, "polishImpl", defaults.polish_impl)),
    )


def train_config_from_yaml(conf: Dict[str, Any]) -> TrainConfig:
    m = _g(conf, "modelParam", {})
    lt = _g(m, "longTermDivNumSteps", [4, 16]) or [4, 16]
    return TrainConfig(
        batch_size=int(_g(conf, "batchSize", 64)),
        max_epochs=int(_g(conf, "maxEpochs", 400)),
        lr=float(_g(m, "lr", 5e-5)),
        p_l2_lambda=float(_g(m, "pL2Lambda", 0.0)),
        div_l2_lambda=float(_g(m, "divL2Lambda", 1.0)),
        p_l1_lambda=float(_g(m, "pL1Lambda", 0.0)),
        div_l1_lambda=float(_g(m, "divL1Lambda", 0.0)),
        div_lt_lambda=float(_g(m, "divLongTermLambda", 1.0)),
        lt_num_steps=(int(lt[0]), int(lt[-1])),
        lt_probability=float(_g(m, "longTermDivProbability", 0.9)),
        train_buoyancy_scale=float(_g(m, "trainBuoyancyScale", 2.0)),
        train_buoyancy_prob=float(_g(m, "trainBuoyancyProb", 0.3)),
        train_gravity_scale=float(_g(m, "trainGravityScale", 0.0)),
        train_gravity_prob=float(_g(m, "trainGravityProb", 0.0)),
        time_scale_sigma=float(_g(m, "timeScaleSigma", 1.0)),
    )


def merge_cli_overrides(conf: Dict[str, Any], overrides: Dict[str, Any]):
    """CLI overrides YAML, like the reference: each override that is not
    None replaces the file's value."""
    out = dict(conf)
    out.update({k: v for k, v in overrides.items() if v is not None})
    return out


# ------------------------------------------------------------------- YAML

# PyYAML's implicit resolvers (yaml/resolver.py), tried in its order for a
# plain scalar: float, int, bool, null, then the timestamp, merge and value
# keys. Of the floats and ints only the plain decimal forms are read; the
# rest raise.
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_OTHER = re.compile(r"""^(?:[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=)$""")
_DEC_FLOAT = re.compile(
    r"^[-+]?(?:[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?$")
_DEC_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
_TRUE = ("yes", "true", "on")
# Characters a plain scalar may not start with, and those that end one
# inside a flow collection.
_INDICATORS = "&*!|>%@`'\"{}[],#"
_FLOW_END = ",[]{}"


def resolve_scalar(text: str):
    """A plain scalar's value as PyYAML's safe_load constructs it; raises
    ValueError for the forms outside the subset."""
    if _FLOAT.match(text) or _INT.match(text) or _OTHER.match(text):
        if _DEC_INT.match(text):
            return int(text)
        if _FLOAT.match(text) and _DEC_FLOAT.match(text):
            return float(text)
        raise ValueError(f"the scalar {text!r} (a number that is not plain "
                         "decimal, a timestamp, merge key or value key)")
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _NULL.match(text):
        return None
    return text


class _Line:
    """A scanner over one line's text: a block mapping's key and value,
    flow collections, quoted and plain scalars."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.s[j] if j < len(self.s) else ""

    def spaces(self):
        while self.peek() == " ":
            self.i += 1

    def at_end(self) -> bool:
        """True at the end of the line or at a comment."""
        self.spaces()
        return self.peek() in ("", "#")

    def blank_after(self, k: int = 1) -> bool:
        return self.peek(k) in ("", " ")

    def value(self, flow: bool):
        self.spaces()
        c = self.peek()
        if c == "[":
            return self.sequence()
        if c == "{":
            return self.mapping()
        if c in "'\"" and c:
            return self.quoted()
        return self.plain(flow)

    def sequence(self):
        self.i += 1
        out = []
        while True:
            self.spaces()
            if self.peek() == "]":
                self.i += 1
                return out
            if self.peek() in ("", "#"):
                raise ValueError("a flow list that goes on past its line")
            out.append(self.value(flow=True))
            self.spaces()
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "]":
                raise ValueError(f"{self.peek()!r} inside a flow list")

    def mapping(self):
        self.i += 1
        out = {}
        while True:
            self.spaces()
            if self.peek() == "}":
                self.i += 1
                return out
            if self.peek() in ("", "#"):
                raise ValueError("a flow mapping that goes on past its line")
            key = self.value(flow=True)
            self.spaces()
            if not (self.peek() == ":" and (self.blank_after()
                                            or self.peek(1) in _FLOW_END)):
                raise ValueError("a flow mapping entry without ': '")
            self.i += 1
            self.spaces()
            out[_key(key)] = (None if self.peek() in (",", "}")
                                   else self.value(flow=True))
            self.spaces()
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "}":
                raise ValueError(f"{self.peek()!r} inside a flow mapping")

    def quoted(self) -> str:
        q = self.peek()
        end = self.s.find(q, self.i + 1)
        if end < 0:
            raise ValueError("a quoted string that goes on past its line "
                             "(multi-line strings)")
        text = self.s[self.i + 1:end]
        self.i = end + 1
        if (q == '"' and "\\" in text) or (q == "'" and self.peek() == "'"):
            raise ValueError("an escape in a quoted string")
        return text

    def plain(self, flow: bool):
        c = self.peek()
        if c == "":
            return None
        if (c in _INDICATORS or (c in "-?:" and (self.blank_after()
                                                 or (flow and self.peek(1)
                                                     in _FLOW_END)))):
            what = {"&": "an anchor", "*": "an alias", "!": "a tag",
                    "|": "a block scalar", ">": "a block scalar",
                    "-": "a block list", "?": "a complex key"}
            raise ValueError(what.get(c, f"a scalar starting with {c!r}"))
        start = self.i
        while True:
            c = self.peek()
            if c == "" or (c == "#" and self.s[self.i - 1] == " "):
                break
            if c == ":" and (self.blank_after()
                             or (flow and self.peek(1) in _FLOW_END)):
                break
            if flow and c in _FLOW_END:
                break
            self.i += 1
        return resolve_scalar(self.s[start:self.i].rstrip(" "))


def _key(key):
    if not isinstance(key, str):
        raise ValueError(f"the key {key!r}, which is not a string")
    return key


def parse_yaml(text: str, source: str = "<string>"):
    """The YAML document ``text`` as ``yaml.safe_load`` reads it, for the
    subset described in the module docstring; None for an empty document.
    Raises ValueError naming ``source`` and the line for anything outside
    the subset."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        content = raw.lstrip(" ")
        if content.strip() == "" or content.startswith("#"):
            continue
        if content[0] == "\t" or "\t" in raw[:len(raw) - len(content)]:
            raise ValueError(f"{source}, line {n}: a tab in the indentation")
        lines.append((n, len(raw) - len(content), content.rstrip()))

    def fail(n, what):
        raise ValueError(f"{source}, line {n}: {what} is outside the YAML "
                         "subset this reader takes")

    def block(i, indent):
        out = {}
        while i < len(lines) and lines[i][1] >= indent:
            n, ind, content = lines[i]
            if ind != indent:
                fail(n, "a line indented deeper than its mapping (a "
                        "multi-line value)")
            if content in ("---", "...") or content[:4] in ("--- ", "... "):
                fail(n, "a document marker (several documents)")
            if content[0] == "%":
                fail(n, "a directive")
            try:
                ln = _Line(content)
                key = _key(ln.value(flow=False))
                if not (ln.peek() == ":" and ln.blank_after()):
                    raise ValueError("a line that is not 'key: value' (a "
                                     "scalar document or multi-line string)")
                ln.i += 1
                empty = ln.at_end()
                val = None if empty else ln.value(flow=False)
                if not ln.at_end():
                    raise ValueError(f"{ln.s[ln.i:]!r} after a value")
            except ValueError as e:
                fail(n, str(e))
            i += 1
            if empty and i < len(lines) and lines[i][1] > indent:
                val, i = block(i, lines[i][1])
            out[key] = val
        return out, i

    if not lines:
        return None
    out, i = block(0, lines[0][1])
    if i < len(lines):
        fail(lines[i][0], "a line indented less than the document's first")
    return out


def load_yaml(path: str):
    """Read a YAML config file with ``parse_yaml`` (never PyYAML)."""
    with open(path) as f:
        return parse_yaml(f.read(), str(path))


def _dump_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if not math.isfinite(v):
            raise ValueError(f"dump_yaml: the float {v}")
        # PyYAML's represent_float: 1e-05 as 1.0e-05, a float on reading.
        r = repr(v).lower()
        return r.replace("e", ".0e", 1) if "." not in r and "e" in r else r
    if not isinstance(v, str):
        raise ValueError(f"dump_yaml: a {type(v).__name__} value")
    if "\n" in v or "\r" in v:
        raise ValueError("dump_yaml: a multi-line string")
    try:
        plain = _Line(v).plain(flow=True) == v and v == v.strip()
    except ValueError:
        plain = False
    if plain and not any(c in v for c in ":#" + _FLOW_END):
        return v
    if "'" not in v:
        return f"'{v}'"
    if '"' not in v and "\\" not in v:
        return f'"{v}"'
    raise ValueError(f"dump_yaml: the string {v!r} needs escapes")


def _dump_key(k) -> str:
    if not isinstance(k, str):
        raise ValueError(f"dump_yaml: the key {k!r}, which is not a string")
    return _dump_scalar(k)


def _dump_flow(v) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_dump_key(k)}: {_dump_flow(x)}"
                               for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_flow(x) for x in v) + "]"
    return _dump_scalar(v)


def dump_yaml(data: Dict[str, Any], path: str = None) -> str:
    """``data`` (a dict) as YAML of ``load_yaml``'s subset: nested dicts as
    block mappings, lists and tuples as flow lists, strings quoted where a
    plain scalar would read back as something else. Writes it to ``path``
    when given; returns the text."""
    def block(d, indent):
        rows = []
        for k, v in d.items():
            head = " " * indent + _dump_key(k) + ":"
            if isinstance(v, dict) and v:
                rows.append(head)
                rows += block(v, indent + 2)
            else:
                rows.append(f"{head} {_dump_flow(v)}")
        return rows

    if not isinstance(data, dict):
        raise ValueError("dump_yaml writes a mapping")
    text = "".join(row + "\n" for row in block(data, 0))
    if path is not None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    return text
