"""Checkpoints of the port (``sdtpu_torch.io.checkpoint``, the train state's
file) against the JAX package's ``sdtpu/io/orbax_ckpt.py`` and
``sdtpu/io/weights.py``, on the CPU at TINY.

A load on a rank of the mesh issues no collective, so it runs here in one
process for every rank of (1, 2), (2, 1) and (2, 2) (a ``Mesh`` built with
the rank's index, as ``tests/test_torch_mesh.py`` builds them for the
plan); a save on a mesh gathers, so it runs in that module's gloo worlds
(``tests/torch_mesh_ranks.py``). Here:

* ``load_checkpoint`` on each rank of each mesh and on one device against
  today's path, ``shard_params(load_native(...))``, leaf by leaf: values,
  dtype, shape and strides; the same file read through ``Context``;
* ``abstract_params`` against the reference's (through the JAX layout)
  and, on a mesh, against ``shard_params``' shapes;
* the reference reading the port's checkpoint, and an orbax directory the
  reference wrote, converted where JAX runs (its ``load_checkpoint``, then
  ``save_native``), loading on a port mesh;
* the train state's file on one device and its slices on a rank; a file of
  one rank's slices (the state's file before it was saved whole) refused;
* ``param_count`` against the reference's; the refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtpu import config as j_config
from sdtpu.io import orbax_ckpt as j_orbax
from sdtpu.io import params as j_params
from sdtpu.io import weights as j_weights
from sdtpu_torch import Context, ErrorCode, SdtpuError
from sdtpu_torch import config as t_config
from sdtpu_torch.io import checkpoint as ck
from sdtpu_torch.io import safetensors as t_st
from sdtpu_torch.io import weights as t_weights
from sdtpu_torch.io.params import (from_jax_tree, init_pipeline_params,
                                   jax_layout, param_count, to_jax_tree)
from sdtpu_torch.parallel import mesh as t_mesh
from sdtpu_torch.parallel import sharding as t_sharding
from sdtpu_torch.train import step as t_step

CFG = t_config.TINY
MESHES = [(1, 1), (1, 2), (2, 1), (2, 2)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and eager ops on TINY tensors lose far more to oversubscribed threads
    than they gain from them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tree():
    return init_pipeline_params(CFG, torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(scope="module")
def saved(tree, tmp_path_factory):
    """A checkpoint directory of TINY's tree (``save_checkpoint`` on one
    device)."""
    d = tmp_path_factory.mktemp("ck") / "model"
    ck.save_checkpoint(tree, d)
    return d


def _ranks(shape):
    return [t_mesh.Mesh(*shape, i) for i in range(shape[0] * shape[1])]


def _assert_same_tree(got, want):
    """Leaf by leaf: the same paths, values, dtype, shape and strides."""
    a, b = t_step.leaves(got), t_step.leaves(want)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        assert (x.dtype, x.shape, x.stride()) == (y.dtype, y.shape,
                                                 y.stride()), p
        assert torch.equal(x, y), p


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("shape", MESHES)
def test_load_checkpoint_is_the_sharded_native_load(saved, shape, dtype):
    """Each rank's ``load_checkpoint`` is ``shard_params(load_native(...))``
    of the same file, leaf by leaf; at (1, 1) (one device) the whole
    tree. Split leaves are fresh tensors of the rank's slice; the plan
    handed back is ``site_plan`` of the whole tree. ``load_native`` itself
    is ``from_jax_tree`` of the file's tensors."""
    file = saved / ck.CHECKPOINT_FILE
    whole = t_weights.load_native(file, CFG, dtype)
    _assert_same_tree(whole, from_jax_tree(t_weights._unflatten_tree(
        t_st.load_file(file)), CFG, dtype=dtype))
    for mesh in _ranks(shape):
        plan = {}
        got = ck.load_checkpoint(saved, CFG, dtype, mesh, plan=plan)
        _assert_same_tree(got, t_sharding.shard_params(whole, mesh, CFG))
        assert plan == t_sharding.site_plan(whole, shape[1], CFG)
        if shape[1] > 1:
            w = got["unet"]["mid"]["st"]["ff1"]["w"]
            assert w.shape[1] * 2 == whole["unet"]["mid"]["st"]["ff1"][
                "w"].shape[1] and w.untyped_storage().size() == (
                    w.numel() * w.element_size())


def test_load_checkpoint_of_a_quantized_tree(tree, tmp_path):
    """A quantized tree is saved as it is and loads as today's path loads
    it: ``w8`` sites whole (the plan replicates them), int8 weights
    column-major, scales float32 under a bfloat16 cast."""
    from sdtpu_torch.quant.ptq import quantize_weights_only

    q = dict(tree)
    q["unet"] = quantize_weights_only(tree["unet"], include_dense=True,
                                      min_elems=0)
    ck.save_checkpoint(q, tmp_path)
    whole = t_weights.load_native(tmp_path / ck.CHECKPOINT_FILE, CFG,
                                  torch.bfloat16)
    for mesh in _ranks((1, 2)):
        _assert_same_tree(
            ck.load_checkpoint(tmp_path, CFG, torch.bfloat16, mesh),
            t_sharding.shard_params(whole, mesh, CFG))


def test_save_checkpoint_is_save_native(tree, saved, tmp_path):
    """On one device the checkpoint is ``save_native``'s file, byte for
    byte (the header from the shapes, the tensors streamed after it)."""
    t_weights.save_native(tree, tmp_path / "n.sdtpu.safetensors")
    assert ((saved / ck.CHECKPOINT_FILE).read_bytes()
            == (tmp_path / "n.sdtpu.safetensors").read_bytes())


def test_reference_reads_the_ports_checkpoint(tree, saved):
    """``sdtpu.io.weights.load_native`` of the port's checkpoint is
    ``to_jax_tree`` of the port's tree, bit for bit."""
    ref = j_weights.load_native(saved / ck.CHECKPOINT_FILE)
    want = to_jax_tree(tree)
    got_flat = t_weights._flatten_tree(ref)
    want_flat = t_weights._flatten_tree(want)
    assert set(got_flat) == set(want_flat)
    for k, v in want_flat.items():
        g = np.asarray(got_flat[k])
        assert g.dtype == v.dtype and g.shape == v.shape, k
        np.testing.assert_array_equal(g, v, err_msg=k)


def _shapes(tree):
    return {t_step.flat_key(p): tuple(t.shape) for p, t in
            t_step.leaves(tree)}


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_abstract_params_is_the_references(dtype):
    """The port's template in the JAX layout has the reference's
    ``abstract_params(cfg, dtype)`` keys, shapes and dtypes; it lives on
    the meta device."""
    ref = j_orbax.abstract_params(j_config.TINY, dtype=dtype)
    ours = ck.abstract_params(CFG, None if dtype is None
                              else getattr(torch, dtype))
    assert all(t.device.type == "meta" for _, t in t_step.leaves(ours))
    flat = {t_step.flat_key(p): t
            for p, t in t_step.leaves(jax_layout(ours))}
    want = t_weights._flatten_tree(ref)
    assert set(flat) == set(want)
    for k, s in want.items():
        assert tuple(flat[k].shape) == tuple(s.shape), k
        assert str(flat[k].dtype).split(".")[1] == str(s.dtype), k


@pytest.mark.parametrize("shape", MESHES[1:])
def test_abstract_params_on_a_mesh_has_the_shard_shapes(tree, shape):
    for mesh in _ranks(shape):
        assert _shapes(ck.abstract_params(CFG, mesh=mesh)) == _shapes(
            t_sharding.shard_params(tree, mesh, CFG))


def test_an_orbax_directory_converted_where_jax_runs(tree, tmp_path):
    """The reference's orbax directory, read by its ``load_checkpoint`` and
    written by its ``save_native`` (where JAX runs), loads on each rank of
    a port mesh as ``shard_params(from_jax_tree(...))`` of the reference's
    tree; the port refuses the directory itself, naming that
    conversion."""
    jtree = jax.tree.map(jnp.asarray, to_jax_tree(tree))
    j_orbax.save_checkpoint(jtree, tmp_path / "orbax")
    restored = j_orbax.load_checkpoint(tmp_path / "orbax", j_config.TINY)
    j_weights.save_native(restored, tmp_path / "m.sdtpu.safetensors")
    whole = from_jax_tree(jax.tree.map(np.asarray, restored), CFG)
    for shape in ((1, 2), (2, 2)):
        for mesh in _ranks(shape):
            _assert_same_tree(
                ck.load_checkpoint(tmp_path / "m.sdtpu.safetensors", CFG,
                                   mesh=mesh),
                t_sharding.shard_params(whole, mesh, CFG))
    for call in (lambda: ck.load_checkpoint(tmp_path / "orbax", CFG),
                 lambda: t_weights.load_pipeline_params(tmp_path / "orbax",
                                                        CFG)):
        with pytest.raises(t_weights.UnsupportedCheckpoint) as ei:
            call()
        assert "sdtpu.io.orbax_ckpt.load_checkpoint" in str(ei.value)
        assert "sdtpu.io.weights.save_native" in str(ei.value)
    assert ck.is_orbax_checkpoint(tmp_path / "orbax")


def test_context_loads_the_checkpoint(saved):
    """``Context(model_dir=)`` on the checkpoint directory serves the
    demo weights' bytes (a Context's demo tree is TINY's float32 init)."""
    a = Context(config="tiny", steps=2, device="cpu")
    b = Context(config="tiny", steps=2, device="cpu", model_dir=str(saved))
    np.testing.assert_array_equal(a.generate(["a fox"], seed=3),
                                  b.generate(["a fox"], seed=3))


def test_load_checkpoint_refusals(tree, tmp_path):
    """A file of another shape is refused naming the key; a directory
    without a native file, and a mesh save without the plan."""
    bad = dict(tree)
    bad["unet"] = dict(tree["unet"], conv_in={
        "w": torch.zeros((8,) + tuple(tree["unet"]["conv_in"]["w"].shape[1:])),
        "b": torch.zeros(8)})
    ck.save_checkpoint(bad, tmp_path / "bad")
    with pytest.raises(ValueError, match=r"unet\.conv_in\.w"):
        ck.load_checkpoint(tmp_path / "bad", CFG)
    with pytest.raises(FileNotFoundError):
        ck.load_checkpoint(tmp_path / "nothing", CFG)
    with pytest.raises(ValueError, match="needs its plan"):
        ck.save_checkpoint(tree, tmp_path / "x",
                           mesh=t_mesh.Mesh(1, 2, 0))


def test_param_count_is_the_references(tree):
    jtree = to_jax_tree(tree)
    assert param_count(tree) == j_params.param_count(jtree) > 0
    c = Context(config="tiny", steps=1, device="cpu")
    assert param_count(c.params) == param_count(tree)


def _state(tree, plan=None, mesh=None):
    """A fresh train state (the EMA on) over TINY's UNet, or over a rank's
    slices of it."""
    unet = tree["unet"]
    if mesh is not None:
        unet = t_sharding.shard_params({"unet": unet}, mesh, CFG,
                                       plan)["unet"]
    masters = t_step._map(lambda t: t.detach().clone(), unet)
    return t_step.init_train_state(masters, t_step.make_optimizer(),
                                   ema=True)


def _fill(state, seed):
    """Every tensor of the state given distinct values (so that a load
    that skipped one shows)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for _, _, t in t_step.state_entries(state):
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=g))
            else:
                t.fill_(seed)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_train_state_loads_a_ranks_slices(tree, tmp_path, shape):
    """A state saved on one device loads on each rank of a mesh as its
    slices (``shard_params`` of each whole tensor), through the memory map
    and with no collective; the file records that it is the logical
    state."""
    plan = t_sharding.site_plan(tree, shape[1], CFG)
    whole = _state(tree)
    _fill(whole, 3)
    t_step.save_train_state(whole, tmp_path)
    file = tmp_path / t_step.STATE_FILE
    header = t_st.read_metadata(file)["sdtpu_torch"]
    assert '"logical": true' in header and '"mesh": [1, 1]' in header
    want = dict(t_step._state_tensors(whole))
    for mesh in _ranks(shape):
        like = _state(tree, plan, mesh)
        _fill(like, 4)
        t_step.load_train_state(tmp_path, like, mesh, plan)
        entries = t_step.state_entries(like)
        specs = t_step._specs(entries, plan)
        assert specs
        for k, _, t in entries:
            w = want[k]
            if k in specs:
                w = t_sharding.take(w, specs[k], shape[1], mesh.coords[1])
            assert t.shape == w.shape and torch.equal(t, w), k


def test_train_state_of_one_ranks_slices_is_refused(tree, tmp_path):
    """The file the state's save wrote on a mesh before it was saved
    whole (each rank's own slices, ROADMAP queue 3): on one device and on
    the other rank it is refused, naming the key."""
    plan = t_sharding.site_plan(tree, 2, CFG)
    rank0 = _state(tree, plan, t_mesh.Mesh(1, 2, 0))
    t_step.save_train_state(rank0, tmp_path)   # no mesh: its slices as-is
    with pytest.raises(ValueError, match="one rank's slice") as ei:
        t_step.load_train_state(tmp_path, _state(tree))
    assert "params/" in str(ei.value)
    with pytest.raises(ValueError, match="params/"):
        t_step.load_train_state(tmp_path, _state(tree, plan,
                                                 t_mesh.Mesh(1, 2, 1)),
                                t_mesh.Mesh(1, 2, 1), plan)
    with pytest.raises(ValueError, match="needs its plan"):
        t_step.load_train_state(tmp_path, rank0, t_mesh.Mesh(1, 2, 0))


def test_stream_writer_takes_the_files_order(tmp_path):
    """The header comes first, from the shapes; each tensor must come in
    the file's order with its header's dtype and shape; a file missing a
    tensor fails on close; the result is ``save_file``'s."""
    ts = {"b": torch.arange(6.0).reshape(2, 3),
          "a": torch.arange(4, dtype=torch.int8),
          "c": torch.ones(3, dtype=torch.bfloat16)}
    specs = {k: (t.dtype, t.shape) for k, t in ts.items()}
    assert t_st.file_order(specs) == ["b", "c", "a"]
    with t_st.StreamWriter(tmp_path / "s", specs, {"m": "1"}) as w:
        with pytest.raises(ValueError, match="out of order"):
            w.write("a", ts["a"])
        with pytest.raises(ValueError, match="header says"):
            w.write("b", ts["b"].double())
        for k in w.order:
            w.write(k, ts[k])
    t_st.save_file(ts, tmp_path / "f", {"m": "1"})
    assert (tmp_path / "s").read_bytes() == (tmp_path / "f").read_bytes()
    w = t_st.StreamWriter(tmp_path / "t", specs)
    w.write("b", ts["b"])
    with pytest.raises(ValueError, match="not written"):
        w.close()


def test_context_refuses_an_orbax_directory_naming_the_conversion(
        tmp_path):
    (tmp_path / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(SdtpuError) as ei:
        Context(config="tiny", steps=1, device="cpu",
                model_dir=str(tmp_path))
    assert ei.value.code == ErrorCode.INVALID_ARGUMENT
    assert "sdtpu.io.orbax_ckpt.load_checkpoint" in ei.value.reason
