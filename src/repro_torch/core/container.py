"""ContainerOps: the port's analogue of MaRe's Docker-image transformations.

A Docker image in MaRe is a *named, versioned, self-contained tool* with
declared input/output mount points.  Here a :class:`ContainerOp` is a named,
versioned, self-contained **tensor transformation** over one partition,
with the same declared mounts.  The registry plays the role of the Docker
registry: ops are ``register``-ed under ``image:tag`` names and ``pull``-ed
by the driver.

A partition is a :class:`Partition` — a fixed-capacity pytree of record
tensors plus a valid-record count kept on the device (shapes are static
per stage, so partitions are padded; ``count`` tracks validity, mirroring
how MaRe staged a variable number of records into a fixed tmpfs mount).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.core import tree
from repro_torch.core.manifests import Contract, ImageManifest
from repro_torch.core.mounts import Mount


class Partition(NamedTuple):
    """One shard-local partition: padded records + valid count."""

    records: Any          # pytree of tensors, leading dim = capacity
    count: torch.Tensor   # int32 0-d tensor, number of valid records

    @property
    def capacity(self) -> int:
        leaves = tree.leaves(self.records)
        return int(leaves[0].shape[0]) if leaves else 0

    def mask(self) -> torch.Tensor:
        """Boolean [capacity] validity mask."""
        return torch.arange(self.capacity, device=self.count.device) \
            < self.count


def make_partition(records: Any, count: Optional[Any] = None) -> Partition:
    """Partition over ``records``; ``count`` defaults to the capacity and
    is placed on the records' device as an int32 scalar."""
    leaves = tree.leaves(records)
    cap = leaves[0].shape[0] if leaves else 0
    device = leaves[0].device if leaves else None
    if count is None:
        count = cap
    if isinstance(count, torch.Tensor):
        count = count.to(device=device or count.device, dtype=torch.int32)
    else:
        count = torch.tensor(int(count), dtype=torch.int32, device=device)
    return Partition(records=records, count=count.reshape(()))


@dataclasses.dataclass(frozen=True)
class ContainerOp:
    """A named transformation over one partition.

    ``fn(partition, **params) -> partition``.  ``image``/``tag`` give the
    registry identity; ``command`` records the originating command string
    (provenance — mirrors the paper's shell command field).  ``out_capacity``
    declares the static record capacity of the output partition.
    ``associative_commutative`` marks combiners that are safe for the
    K-level reduce tree (paper §1.2.2).

    ``manifest`` is the image's declarative contract (schemas, capacity
    transfer, monoid, command grammar); ``contract`` is that manifest
    resolved against this op's command + params at pull time — the record
    the planner type-checks at plan-build time.  Ops constructed directly
    (no registry) carry neither.
    """

    image: str
    fn: Callable[..., Partition]
    input_mount: Optional[Mount] = None
    output_mount: Optional[Mount] = None
    command: str = ""
    tag: str = "latest"
    out_capacity: Optional[int] = None
    associative_commutative: bool = False
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    manifest: Optional[ImageManifest] = None
    contract: Optional[Contract] = None

    @property
    def name(self) -> str:
        return f"{self.image}:{self.tag}"

    def __call__(self, part: Partition) -> Partition:
        out = self.fn(part, **self.params)
        if not isinstance(out, Partition):
            raise TypeError(
                f"container {self.name} must return a Partition, got "
                f"{type(out).__name__}")
        return out

    def with_mounts(self, input_mount: Mount, output_mount: Mount,
                    command: str = "") -> "ContainerOp":
        return dataclasses.replace(
            self, input_mount=input_mount, output_mount=output_mount,
            command=command or self.command)


class Registry:
    """Name -> ContainerOp factory (the "Docker registry")."""

    def __init__(self) -> None:
        self._images: Dict[str, Callable[..., ContainerOp]] = {}

    def register(self, image: str, tag: str = "latest"
                 ) -> Callable[[Callable[..., ContainerOp]],
                               Callable[..., ContainerOp]]:
        key = f"{image}:{tag}"

        def deco(factory: Callable[..., ContainerOp]):
            if key in self._images:
                raise ValueError(f"image {key} already registered")
            self._images[key] = factory
            return factory

        return deco

    def pull(self, image: str, **build_args: Any) -> ContainerOp:
        key = image if ":" in image else f"{image}:latest"
        if key not in self._images:
            raise KeyError(
                f"image {key!r} not found in registry; available: "
                f"{sorted(self._images)}")
        return self._images[key](**build_args)

    def images(self):
        return sorted(self._images)


#: Global default registry (like the Docker Hub default).
DEFAULT_REGISTRY = Registry()
register = DEFAULT_REGISTRY.register
pull = DEFAULT_REGISTRY.pull


def container_op(image: str, *, tag: str = "latest",
                 out_capacity: Optional[int] = None,
                 associative_commutative: bool = False,
                 manifest: Optional[ImageManifest] = None,
                 registry: Registry = DEFAULT_REGISTRY,
                 **default_params: Any):
    """Decorator: register ``fn(partition, **params) -> Partition``.

    The decorated function becomes an image factory: ``pull(image,
    **params)`` binds params and returns a :class:`ContainerOp`.

    When a ``manifest`` is given, the pull-time ``command`` string is
    parsed through its typed grammar (typed args, pull-time errors for
    unknown commands / bad arguments); a :class:`CommandSpec` may dispatch
    to its own implementation fn.  Without a manifest a non-empty command
    is passed to ``fn`` as the ``command`` keyword.
    """

    def deco(fn: Callable[..., Partition]) -> Callable[..., ContainerOp]:
        def factory(**params: Any) -> ContainerOp:
            command = params.pop("command", "") or ""
            merged = dict(default_params)
            impl = fn
            assoc = associative_commutative
            contract = None
            if manifest is not None:
                spec, parsed = manifest.parse_command(command, image=image)
                merged.update(params)
                merged.update(parsed)   # the command's argv wins over kwargs
                if spec is not None:
                    if spec.fn is not None:
                        impl = spec.fn
                    if spec.associative_commutative is not None:
                        assoc = spec.associative_commutative
                elif command:
                    # manifest without a grammar: the command string is
                    # passed through for the image to interpret
                    merged["command"] = command
                contract = manifest.resolve(spec, merged, image=image,
                                            command=command)
            else:
                merged.update(params)
                if command:
                    merged["command"] = command
            return ContainerOp(
                image=image, tag=tag, fn=impl, command=command,
                out_capacity=merged.pop("out_capacity", out_capacity),
                associative_commutative=assoc,
                params=merged, manifest=manifest, contract=contract)

        registry.register(image, tag)(factory)
        factory.__name__ = fn.__name__
        factory.op = factory  # convenience alias
        return factory

    return deco
