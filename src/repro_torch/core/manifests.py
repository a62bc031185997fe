"""Typed image manifests: the declarative contract of a container image.

The paper's container interface (§1.2.1, Listings 1-3) is a *convention*:
an image declares input/output mount points and a command string it knows
how to interpret.  An :class:`ImageManifest` makes that contract a machine-
checked record attached at registration:

* **record schemas** — declared input/output :class:`~repro_torch.core.schema.
  Schema` pytrees (dtype + per-record shape, symbolic dims allowed);
* **capacity transfer** — ``out_capacity = f(in_capacity, env)`` where
  ``env`` is the op's params plus the dims bound by input-schema
  unification (``grep-count -> 1``, ``kmer-stats -> cap * (W - k + 1)``);
* **monoid** — reduce/merge algebra the image implements (``"sum"`` /
  ``"max"`` / ``"min"``), consumed by ``reduce_by_key``'s container
  spelling instead of hard-coded image tables;
* **key space** — for key-emitting images, the declared size of the key
  range their output records' key leaf (by convention the FIRST record
  leaf) covers (``kmer-stats: 4**k``), so downstream key tables can be
  sized — and bounds-checked — at plan time;
* **command grammar** — declared commands with typed args, replacing
  per-image ``shlex`` micro-parsers; each :class:`CommandSpec` may carry
  its own implementation fn and contract overrides (the `posix` image is
  really three tools behind one ENTRYPOINT).

The planner consumes resolved :class:`Contract` objects to type-check a
whole stage DAG at plan-build time (see ``repro_torch.core.plan.infer_states``).
"""
from __future__ import annotations

import dataclasses
import shlex
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from repro_torch.core.schema import (Schema, SchemaMismatch, substitute, unify)


class PlanTypeError(TypeError):
    """A pipeline violates a declared image contract at plan-build time.

    Raised while *building* a chain (``MaRe.map(...)`` etc.), with the
    stage index and both schemas in the message — instead of a shape error
    from inside the lowered program at action time.
    """


#: ``out_capacity`` marker: the op keeps its input partition capacity
#: (for a reduce combiner this means concat-like growth — see plan.py).
PRESERVE = "preserve"


def SAME(schema: Optional[Schema], env: Mapping[str, Any]
         ) -> Optional[Schema]:
    """``output_schema`` transfer: records pass through unchanged."""
    return schema


_REQUIRED = object()


@dataclasses.dataclass(frozen=True)
class ArgSpec:
    """One positional argument of a command grammar.

    ``type`` coerces the token (``int`` / ``float`` / ``str``);
    ``variadic`` consumes all remaining tokens into a tuple; optional args
    (``required=False``) emit nothing when absent, deferring to the
    image's registered parameter defaults.
    """

    name: str
    type: Callable[[str], Any] = str
    required: bool = True
    variadic: bool = False


#: Sentinel: a CommandSpec field inherits the image-level manifest value.
_INHERIT = None


@dataclasses.dataclass(frozen=True)
class CommandSpec:
    """One command of an image's typed grammar (+ contract overrides).

    ``fn`` optionally overrides the image's registered implementation
    (command dispatch); contract fields left ``None`` inherit the
    image-level manifest defaults.
    """

    name: str
    args: Tuple[ArgSpec, ...] = ()
    fn: Optional[Callable[..., Any]] = None
    input_schema: Optional[Schema] = _INHERIT
    output_schema: Any = _INHERIT            # Schema | callable | None
    out_capacity: Any = _INHERIT             # int | callable | PRESERVE
    monoid: Optional[str] = _INHERIT
    key_space: Any = _INHERIT                # int | callable(env) -> int
    associative_commutative: Optional[bool] = None

    def parse(self, argv: List[str], image: str) -> Dict[str, Any]:
        """Coerce ``argv`` (tokens after the command name) to typed params."""
        params: Dict[str, Any] = {}
        rest = list(argv)
        for spec in self.args:
            if spec.variadic:
                if not rest:
                    if spec.required:
                        raise ValueError(
                            f"image {image!r} command {self.name!r}: "
                            f"missing required argument {spec.name!r}")
                    continue   # optional + absent: defer to defaults
                try:
                    params[spec.name] = tuple(spec.type(a) for a in rest)
                except ValueError as e:
                    raise ValueError(
                        f"image {image!r} command {self.name!r}: bad "
                        f"argument for {spec.name!r}: {e}") from e
                rest = []
            elif rest:
                tok = rest.pop(0)
                try:
                    params[spec.name] = spec.type(tok)
                except ValueError as e:
                    raise ValueError(
                        f"image {image!r} command {self.name!r}: argument "
                        f"{spec.name!r} expects {spec.type.__name__}, got "
                        f"{tok!r}") from e
            elif spec.required:
                raise ValueError(
                    f"image {image!r} command {self.name!r}: missing "
                    f"required argument {spec.name!r}")
        if rest:
            raise ValueError(
                f"image {image!r} command {self.name!r}: unexpected "
                f"arguments {rest}")
        return params


@dataclasses.dataclass(frozen=True)
class Contract:
    """A manifest resolved against one op's command + params.

    This is what the planner consumes: the command-level overrides are
    already merged over the image-level defaults, and ``params`` holds the
    fully-merged op parameters feeding the transfer functions' ``env``.
    """

    label: str                               # e.g. "ubuntu[grep-chars]"
    input_schema: Optional[Schema] = None
    output_schema: Any = None
    out_capacity: Any = PRESERVE
    monoid: Optional[str] = None
    key_space: Any = None
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def check_input(self, actual: Schema) -> Dict[str, Any]:
        """Unify the incoming schema against the declared input contract;
        returns the transfer-function ``env`` (params + bound dims)."""
        env: Dict[str, Any] = dict(self.params)
        if self.input_schema is None:
            return env
        bound = unify(self.input_schema, actual,
                      {k: v for k, v in env.items() if isinstance(v, int)})
        env.update(bound)
        return env

    def infer_output_schema(self, in_schema: Optional[Schema],
                            env: Mapping[str, Any]) -> Optional[Schema]:
        if self.output_schema is None:
            return None
        if callable(self.output_schema):
            return self.output_schema(in_schema, env)
        dims = {k: v for k, v in env.items() if isinstance(v, int)}
        return substitute(self.output_schema, dims)

    def infer_out_capacity(self, in_capacity: Optional[int],
                           env: Mapping[str, Any]) -> Optional[int]:
        oc = self.out_capacity
        if oc == PRESERVE:
            return in_capacity
        if callable(oc):
            if in_capacity is None:
                return None
            try:
                cap = int(oc(in_capacity, env))
            except KeyError:
                return None      # transfer needs a dim the schema didn't bind
            if cap < 1:
                raise ValueError(
                    f"capacity transfer of {self.label} yields {cap} "
                    f"(in_capacity={in_capacity}, env={dict(env)})")
            return cap
        return None if oc is None else int(oc)

    def infer_key_space(self, env: Mapping[str, Any]) -> Optional[int]:
        ks = self.key_space
        if callable(ks):
            try:
                return int(ks(env))
            except KeyError:
                return None
        return None if ks is None else int(ks)


@dataclasses.dataclass(frozen=True)
class ImageManifest:
    """Declarative contract attached to a registered image.

    Image-level fields are the defaults; entries in ``commands`` are the
    typed grammar and may override any contract field per command.
    ``default_command`` names the command used when an op is pulled with
    an empty command string; with a non-empty grammar and no default, an
    empty command is a pull-time error (the ENTRYPOINT needs an argv).
    """

    input_schema: Optional[Schema] = None
    output_schema: Any = None                # Schema | callable | None
    out_capacity: Any = PRESERVE             # int | callable | PRESERVE
    monoid: Optional[str] = None
    key_space: Any = None                    # int | callable(env) -> int
    commands: Tuple[CommandSpec, ...] = ()
    default_command: Optional[str] = None

    def command_names(self) -> Tuple[str, ...]:
        return tuple(sorted(c.name for c in self.commands))

    def find_command(self, name: str) -> Optional[CommandSpec]:
        for c in self.commands:
            if c.name == name:
                return c
        return None

    def parse_command(self, command: str, image: str
                      ) -> Tuple[Optional[CommandSpec], Dict[str, Any]]:
        """Parse a command string through the typed grammar.

        Returns ``(spec, typed params)``; ``(None, {})`` when the image
        has no grammar (the command string, if any, is passed through to
        the implementation untyped, as before manifests).
        """
        if not self.commands:
            return None, {}
        argv = shlex.split(command)
        if not argv:
            if self.default_command is None:
                raise ValueError(
                    f"image {image!r} requires a command; grammar: "
                    f"{', '.join(self.command_names())}")
            spec = self.find_command(self.default_command)
            assert spec is not None, (image, self.default_command)
            return spec, spec.parse([], image)
        spec = self.find_command(argv[0])
        if spec is None:
            raise ValueError(
                f"image {image!r}: unknown command {argv[0]!r}; grammar: "
                f"{', '.join(self.command_names())}")
        return spec, spec.parse(argv[1:], image)

    def resolve(self, spec: Optional[CommandSpec],
                params: Mapping[str, Any], *, image: str,
                command: str = "") -> Contract:
        """Merge command-level overrides over image defaults."""

        def pick(field_name: str) -> Any:
            if spec is not None:
                val = getattr(spec, field_name)
                if val is not _INHERIT:
                    return val
            return getattr(self, field_name)

        label = (f"{image}[{spec.name}]"
                 if spec is not None and spec.name != image else image)
        return Contract(
            label=label,
            input_schema=pick("input_schema"),
            output_schema=pick("output_schema"),
            out_capacity=pick("out_capacity"),
            monoid=pick("monoid"),
            key_space=pick("key_space"),
            params=dict(params))


__all__ = [
    "ArgSpec", "CommandSpec", "Contract", "ImageManifest", "PlanTypeError",
    "PRESERVE", "SAME", "SchemaMismatch",
]
