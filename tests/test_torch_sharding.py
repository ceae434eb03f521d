"""The port's mesh layer against the reference's pure rule logic, on the
CPU, in one process.

``repro_torch.launch.sharding`` (``ShardingRules``, ``rules_for``,
``param_shardings``, ``abstract_params``), ``launch.train.batch_spec``,
``launch.mesh`` and the ``models.layers`` helpers (``abstract_from_specs``,
``mesh_context``, ``current_mesh_rules``, ``shard``,
``activation_shardings``) against ``repro.launch.sharding``,
``repro.launch.train.batch_spec`` and ``repro.models.layers``.  The
reference runs on ``jax.sharding.AbstractMesh``, the port on its
``AbstractMesh``: the smoke ``(1, 1)`` and the production ``(16, 16)`` and
``(2, 16, 16)`` meshes, with ``fsdp`` and ``seq_shard`` each on and off.
Specs must be equal entry for entry; the port's placements must be the
ones the reference's ``PartitionSpec`` names (``Shard(d)`` on each mesh
dim that shards tensor dim ``d``); and on small meshes the slice each
mesh place gets must be the one the reference's spec gives it (each
tuple of axes split major to minor).

The reference is imported inside the test bodies.
"""
import ast
import itertools
import os
import re
import threading
from types import SimpleNamespace

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs import ARCH_IDS, RunConfig, get_config, smoke_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel

HERE = os.path.dirname(os.path.abspath(__file__))
REF_MODELS = os.path.join(HERE, os.pardir, "src", "repro", "models")

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
FLAGS = list(itertools.product((False, True), (False, True)))


def _shard_sites() -> dict:
    """``{"file:line": axes}`` of every ``shard(x, *axes)`` call in the
    reference's model code."""
    out = {}
    for name in sorted(os.listdir(REF_MODELS)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(REF_MODELS, name)) as f:
            for i, line in enumerate(f, 1):
                m = re.search(r"=\s*shard\(\w+, (.*)\)\s*$", line)
                if m:
                    out[f"{name}:{i}"] = ast.literal_eval(f"({m.group(1)},)")
    return out


SITES = _shard_sites()


def _meshes(key):
    from jax.sharding import AbstractMesh

    shape, names = MESHES[key]
    return AbstractMesh(shape, names), tmesh.AbstractMesh(shape, names)


def _norm(spec) -> tuple:
    """A spec of either package as a plain tuple (``"U"`` for an
    unconstrained dim)."""
    from jax.sharding import PartitionSpec as P

    return tuple("U" if e is P.UNCONSTRAINED or e is tsh.UNCONSTRAINED
                 else e for e in spec)


def _want_placements(spec, names) -> tuple:
    """The placements the reference's spec names on a mesh of ``names``."""
    from jax.sharding import PartitionSpec as P

    out = [Replicate()] * len(names)
    for d, e in enumerate(spec):
        if e is None or e is P.UNCONSTRAINED:
            continue
        for a in ((e,) if isinstance(e, str) else e):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh):
    """Every ``ParamSpec`` leaf of the full-size model: ``rules_for``'s
    table, ``partition_spec`` (with and without shape and mesh),
    ``param_shardings`` / ``abstract_params`` placements, shapes and
    dtypes, and ``abstract_from_specs`` (no storage), as the reference's,
    with ``fsdp`` and ``seq_shard`` on and off."""
    from repro.configs import RunConfig as RRun
    from repro.configs import get_config as r_get
    from repro.launch import sharding as rsh
    from repro.models import layers as rlayers
    from repro.models import model as rmodel

    r_mesh, t_mesh = _meshes(mesh)
    names = MESHES[mesh][1]
    r_tree = rmodel.model_specs(r_get(arch))
    t_tree = tmodel.model_specs(get_config(arch))
    r_specs, t_specs = _flat(r_tree), _flat(t_tree)
    assert r_specs.keys() == t_specs.keys()
    r_abs0 = _flat(rlayers.abstract_from_specs(r_tree))
    t_abs0 = _flat(tlayers.abstract_from_specs(t_tree))
    assert _flat(tsh.abstract_params(t_tree)) == t_abs0
    for path, r in r_abs0.items():
        t = t_abs0[path]
        assert isinstance(t, tlayers.ShapeDtypeStruct), path
        assert t.shape == r.shape and t.placements is None, path
        assert _dtype_name(t.dtype) == str(r.dtype), path
    for fsdp, seq in FLAGS:
        rr = rsh.rules_for(r_mesh, RRun(fsdp=fsdp, seq_shard=seq))
        tr = tsh.rules_for(t_mesh, RunConfig(fsdp=fsdp, seq_shard=seq))
        assert tr.table == rr.table
        r_abs = _flat(rsh.abstract_params(r_tree, r_mesh, rr))
        t_abs = _flat(tsh.abstract_params(t_tree, t_mesh, tr))
        t_sh = _flat(tsh.param_shardings(t_tree, t_mesh, tr))
        for path, rs in r_specs.items():
            ts = t_specs[path]
            assert (ts.shape, ts.axes) == (rs.shape, rs.axes), path
            want = rr.partition_spec(rs.axes, shape=rs.shape, mesh=r_mesh)
            got = tr.partition_spec(ts.axes, shape=ts.shape, mesh=t_mesh)
            assert _norm(got) == _norm(want), (path, fsdp, seq)
            assert _norm(tr.partition_spec(ts.axes)) == _norm(
                rr.partition_spec(rs.axes)), path
            assert _norm(r_abs[path].sharding.spec) == _norm(want), path
            pl = _want_placements(want, names)
            assert t_sh[path] == pl, (path, fsdp, seq)
            assert t_abs[path].placements == pl, path
            assert t_abs[path].shape == r_abs[path].shape, path
            assert _dtype_name(t_abs[path].dtype) == str(r_abs[path].dtype)


@pytest.mark.parametrize("site", list(SITES))
def test_activation_specs_match_reference(site):
    """Each activation constraint of the reference's models (its logical
    axes, read from the call): ``partition_spec(...,
    unconstrained_fallback=True)`` as the reference's on every mesh and
    flag setting, over shapes whose dims the mesh axes divide and do not
    (1, 24, 32, 512 a dim)."""
    from repro.configs import RunConfig as RRun
    from repro.launch import sharding as rsh

    axes = SITES[site]
    sizes = (1, 24, 32, 512)
    n = 0
    for mesh in MESHES:
        r_mesh, t_mesh = _meshes(mesh)
        for fsdp, seq in FLAGS:
            rr = rsh.rules_for(r_mesh, RRun(fsdp=fsdp, seq_shard=seq))
            tr = tsh.rules_for(t_mesh, RunConfig(fsdp=fsdp, seq_shard=seq))
            for shape in itertools.product(sizes, repeat=len(axes)):
                want = rr.partition_spec(axes, shape=shape, mesh=r_mesh,
                                         unconstrained_fallback=True)
                got = tr.partition_spec(axes, shape=shape, mesh=t_mesh,
                                        unconstrained_fallback=True)
                assert _norm(got) == _norm(want), (mesh, fsdp, seq, shape)
                n += "U" in _norm(want)
    assert n > 0          # the fallback was reached


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["deepseek_7b", "musicgen_medium"])
def test_batch_spec_matches_reference(arch, mesh):
    """``batch_spec`` for a tokens arch and an embeds arch: the
    reference's names, shapes and dtypes (int32 ``labels``/``tokens``,
    bf16 ``embeds``), and the placements its specs name."""
    from repro.configs import RunConfig as RRun
    from repro.configs import get_config as r_get
    from repro.configs.shapes import ShapeConfig
    from repro.launch import sharding as rsh
    from repro.launch.train import batch_spec as r_batch_spec

    r_mesh, t_mesh = _meshes(mesh)
    names = MESHES[mesh][1]
    for fsdp, (seq, batch) in itertools.product(
            (False, True), ((4096, 256), (32768, 8), (16, 1), (64, 48))):
        rr = rsh.rules_for(r_mesh, RRun(fsdp=fsdp))
        tr = tsh.rules_for(t_mesh, RunConfig(fsdp=fsdp))
        want = r_batch_spec(r_get(arch), ShapeConfig("x", "train", seq,
                                                     batch), r_mesh, rr)
        got = ttrain.batch_spec(get_config(arch), SimpleNamespace(
            global_batch=batch, seq_len=seq), t_mesh, tr)
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert got[k].shape == w.shape, k
            assert _dtype_name(got[k].dtype) == str(w.dtype), k
            assert got[k].placements == _want_placements(
                w.sharding.spec, names), (k, fsdp, seq, batch)


def test_mesh_context_nests_and_restores():
    """``mesh_context`` nests and restores the outer context on exit
    (also when the block raises); it is per thread; ``shard`` is the
    identity outside a context and on a plain tensor inside one."""
    x = torch.ones(4, 3)
    m1, m2 = tmesh.AbstractMesh((1, 1), ("data", "model")), \
        tmesh.AbstractMesh((2, 1, 1), ("pod", "data", "model"))
    r1, r2 = tsh.rules_for(m1, RunConfig()), tsh.rules_for(m2, RunConfig())
    assert tlayers.current_mesh_rules() is None
    assert tlayers.shard(x, "batch", None) is x
    with tlayers.mesh_context(m1, r1):
        assert tlayers.current_mesh_rules() == (m1, r1)
        assert tlayers.shard(x, "batch", None) is x
        with tlayers.mesh_context(m2, r2):
            assert tlayers.current_mesh_rules() == (m2, r2)
            seen = []
            t = threading.Thread(
                target=lambda: seen.append(tlayers.current_mesh_rules()))
            t.start()
            t.join(10)
            assert not t.is_alive() and seen == [None]
        assert tlayers.current_mesh_rules() == (m1, r1)
        with pytest.raises(KeyError):
            with tlayers.mesh_context(m2, r2):
                raise KeyError("inner")
        assert tlayers.current_mesh_rules() == (m1, r1)
    assert tlayers.current_mesh_rules() is None


def test_activation_shardings_match_reference():
    """``activation_shardings`` raises outside a context (as the
    reference does) and inside one gives the placements of the
    reference's specs, for a nested tree and a single tuple."""
    from repro.configs import RunConfig as RRun
    from repro.launch import sharding as rsh
    from repro.models import layers as rlayers

    tree = {"x": ("batch", "seq", None),
            "deep": {"q": ("batch", None, "heads", None),
                     "e": ("experts", None, None)}}
    with pytest.raises(RuntimeError):
        tlayers.activation_shardings(tree)
    with pytest.raises(RuntimeError):
        rlayers.activation_shardings(tree)
    for mesh in MESHES:
        r_mesh, t_mesh = _meshes(mesh)
        names = MESHES[mesh][1]
        run = dict(fsdp=True, seq_shard=True)
        with rlayers.mesh_context(r_mesh, rsh.rules_for(r_mesh, RRun(**run))):
            want = _flat(rlayers.activation_shardings(tree))
        with tlayers.mesh_context(t_mesh, tsh.rules_for(t_mesh,
                                                         RunConfig(**run))):
            got = _flat(tlayers.activation_shardings(tree))
            assert tlayers.activation_shardings(tree["x"]) == got["x"]
        assert got == {k: _want_placements(v.spec, names)
                       for k, v in want.items()}


@pytest.fixture
def smoke_mesh():
    """The one-rank smoke mesh on the CPU; the one-rank group it starts
    is destroyed afterwards."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    try:
        yield tmesh.make_smoke_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_smoke_mesh_and_shard_redistribute(smoke_mesh):
    """The smoke mesh is the reference's ``(1, 1)`` ``("data", "model")``
    mesh; on it ``shard`` redistributes a DTensor to its axes' placements
    and keeps a current ``Shard`` on a dim left unconstrained."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import axis_sizes

    assert axis_sizes(smoke_mesh) == {"data": 1, "model": 1}
    assert smoke_mesh.device_type == "cpu"
    rules = tsh.rules_for(smoke_mesh, RunConfig())
    x = torch.arange(24.0).reshape(2, 3, 4)
    dt = DTensor.from_local(x, smoke_mesh, (Replicate(), Shard(1)),
                            run_check=False)
    assert tlayers.shard(dt, "batch", "seq", None) is dt   # no context
    with tlayers.mesh_context(smoke_mesh, rules):
        out = tlayers.shard(dt, "batch", "seq", None)
        assert isinstance(out, DTensor)
        # batch → data; seq has no rule: the model dim keeps Shard(1)
        assert out.placements == (Shard(0), Shard(1))
        assert torch.equal(out.full_tensor(), x)
        # seq sharded on model: Shard(1) there by the rule
        seq = tsh.rules_for(smoke_mesh, RunConfig(seq_shard=True))
        with tlayers.mesh_context(smoke_mesh, seq):
            out = tlayers.shard(dt, None, None, "vocab")
            assert out.placements == (Replicate(), Shard(2))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_needs_its_ranks(multi_pod):
    """Without 256 (512) ranks both packages' ``make_production_mesh``
    raise ``ValueError``; the port's also needs the card by default."""
    from repro.launch.mesh import make_production_mesh as r_make

    with pytest.raises(ValueError):
        r_make(multi_pod=multi_pod)
    with pytest.raises(ValueError):
        tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tmesh.make_production_mesh(multi_pod=multi_pod)


def _ref_slice(spec, shape, sizes: dict, coord: dict) -> tuple:
    """The index ranges the reference's spec gives the mesh place
    ``coord``: each tuple of axes splits its dim major to minor."""
    out = []
    for d, n in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        axes = () if e is None else ((e,) if isinstance(e, str) else e)
        k, idx = 1, 0
        for a in axes:
            idx = idx * sizes[a] + coord[a]
            k *= sizes[a]
        out.append(slice(idx * n // k, (idx + 1) * n // k))
    return tuple(out)


@pytest.mark.parametrize("shape,names", [
    ((2, 2), ("data", "model")),
    ((2, 1, 2), ("pod", "data", "model")),
    ((2, 2, 2), ("pod", "data", "model"))])
def test_local_slices_match_reference_specs(shape, names):
    """On small meshes, every mesh place's slice of each smoke model's
    parameters (``fsdp`` on and off) and of a global batch, under the
    port's placements (``local_slice``, as DTensor splits), equals the
    slice the reference's ``PartitionSpec`` gives that place."""
    from jax.sharding import AbstractMesh

    from repro.configs import RunConfig as RRun
    from repro.configs import smoke_config as r_smoke
    from repro.launch import sharding as rsh
    from repro.models import model as rmodel

    r_mesh, t_mesh = AbstractMesh(shape, names), tmesh.AbstractMesh(shape,
                                                                    names)
    sizes = dict(zip(names, shape))
    coords = list(itertools.product(*(range(n) for n in shape)))
    cases = []
    for arch in ARCH_IDS:
        r_tree = _flat(rmodel.model_specs(r_smoke(arch)))
        t_tree = _flat(tmodel.model_specs(smoke_config(arch)))
        for fsdp in (False, True):
            rr = rsh.rules_for(r_mesh, RRun(fsdp=fsdp))
            tr = tsh.rules_for(t_mesh, RunConfig(fsdp=fsdp))
            for path, rs in r_tree.items():
                cases.append((rr.partition_spec(rs.axes, shape=rs.shape,
                                                mesh=r_mesh),
                              tsh.placements(tr.partition_spec(
                                  t_tree[path].axes, shape=rs.shape,
                                  mesh=t_mesh), t_mesh), rs.shape))
        batch = (8, 6)
        cases.append((rr.partition_spec(("batch", None), shape=batch,
                                        mesh=r_mesh),
                      ttrain.batch_spec(get_config(arch), SimpleNamespace(
                          global_batch=8, seq_len=6), t_mesh, tr)[
                          "labels"].placements, batch))
    split = 0
    for want_spec, pls, shp in cases:
        t = torch.arange(int(torch.tensor(shp).prod())).reshape(shp)
        for c in coords:
            want = t[_ref_slice(want_spec, shp, sizes, dict(zip(names, c)))]
            got = tsh.local_slice(t, t_mesh, pls, c)
            assert torch.equal(got, want), (want_spec, shp, c)
        split += sum(isinstance(e, tuple) for e in want_spec)
    assert split > 0 or shape == (2, 2)   # two axes on one dim were held


def test_placements_reject_what_dtensor_cannot_split():
    """A tuple of axes out of the mesh's order, or an axis the mesh
    lacks, raises: DTensor splits a dim across mesh dims in their order
    only."""
    m = tmesh.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    assert tsh.placements(tsh.PartitionSpec(("pod", "data")), m) == (
        Shard(0), Shard(0), Replicate())
    with pytest.raises(ValueError):
        tsh.placements(tsh.PartitionSpec(("data", "pod")), m)
    with pytest.raises(ValueError):
        tsh.placements(tsh.PartitionSpec("expert"), m)
    with pytest.raises(ValueError):
        tmesh.AbstractMesh((2, 2), ("data", "data"))
