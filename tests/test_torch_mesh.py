"""Serving on the (data, model) mesh (``sdtpu_torch.parallel``) against the
JAX package's ``sdtpu/parallel``, on the CPU.

* The plan: the port's ``param_pspecs`` against the reference's, leaf by
  leaf, on the TINY tree and on SD1.5's and SDXL's full-width trees (the
  reference's through ``jax.eval_shape``, the port's on the meta device).
  The port decides per site, so each disagreement must be one of the
  listed divergences (``_divergence``): whole heads, GEGLU's halves, a
  fused projection's sections, a weight-only-int8 site.
* The mesh: gloo worlds of two and four CPU processes
  (``tests/torch_mesh_ranks.py``, started once for the module, through a
  ``file://`` store under the test's temporary directory) serve every
  entry point the reference routes to its mesh on (1, 2), (2, 1) and
  (2, 2), at TINY in float32: each within 1 uint8 LSB of the same call on
  a Context without a mesh (the bound ``tests/test_parallel.py`` holds the
  reference's mesh to), and the port's pipeline functions on a rank's split
  tree, with the reference's draws handed in through the seams, within
  1e-4 (latents) and 1 LSB (images) of the reference's single-device
  result. Every rank returns the whole batch, the same bytes.
* The refusals: a batch the data axis does not divide, a mesh larger than
  the world, with the reference's code and text.
* The collectives a rank issues, pinned from the plan.
* The rest of the mesh, in the same worlds: the stream pool on every mesh;
  the train step on (1, 2), (2, 1) and (2, 2) against the reference's
  single-device step with its draws (``sdtpu.train.step``'s loss and
  optax's update, as ``tests/test_torch_train.py`` runs them): the loss
  within ``rtol=2e-5`` (``tests/test_train.py:100``), the gathered params,
  moments and EMA within ``test_torch_train``'s bounds, the replicated
  leaves the same bits on every rank; ``global_norm`` of a replicated and a
  split leaf; the spatial partition on (1, 2) and (2, 2) within 1 uint8 LSB
  of the reference's single-device ``generate`` (``tests/test_parallel.py:
  179``), also where a level does not tile the model axis, with its
  collectives (the collective-permutes of the halos) derived from the
  UNet's structure; and ``sdtpu-torch serve --mesh 1,2``, started as a user
  starts it, answering with the bytes of ``Context(mesh=(1, 2))``.
* Checkpoints on the mesh (``io.checkpoint``, the train state's file), in
  the same worlds: the logical file written by rank 0 alone, loaded back
  on the mesh, on another mesh and on one device bit for bit; a step after
  the reload the uninterrupted step's bits. A load on a rank issues no
  collective, so each rank's slices are also held against
  ``shard_params`` in one process (``tests/test_torch_checkpoint.py``).
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from jax.tree_util import tree_flatten_with_path

from sdtpu import config as j_config
from sdtpu.io import params as j_params
from sdtpu.parallel import mesh as j_mesh
from sdtpu.parallel import sharding as j_sharding
from sdtpu_torch import Context, ErrorCode, SdtpuError
from sdtpu_torch import config as t_config
from sdtpu_torch.io.params import init_pipeline_params, init_tree, tree_names
from sdtpu_torch.models import layers as t_layers
from sdtpu_torch.parallel import collectives
from sdtpu_torch.parallel import mesh as t_mesh
from sdtpu_torch.parallel import sharding as t_sharding
from sdtpu_torch.train import step as t_step
from sdtpu_torch.train.lora import extract_lora, inject_lora, save_lora_npz
from test_torch_image import (CFGS, _draws, _image, _mask, _reference_latents,
                              _shape, _text, assert_close, ref, trees)
from test_torch_train import _Ref, _check_state, _end_to_end
from test_torch_train import _batch as _train_batch
from test_torch_train import _draws as _train_draws
from test_torch_train import _frozen as _train_frozen

import torch_mesh_ranks as R

ROOT = Path(__file__).resolve().parent.parent
WORLDS = {2: ["1x2", "2x1"], 4: ["2x2"]}
MESHES = [m for ms in WORLDS.values() for m in ms]
#: an anchor -> its configuration's name in ``test_torch_image.CFGS``
ANCHOR_CFG = {"anchor_generate": "tiny", "anchor_img2img": "tiny",
              "anchor_inpaint": "tiny", "anchor_inpaint9": "inpaint",
              "anchor_xl_inpaint9": "xl_inpaint"}
ANCHOR_SEED = 7
RANK_TIMEOUT_S = 300

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and eager ops on TINY tensors lose far more to oversubscribed threads
    than they gain from them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def _no_tf32():
    t_layers.disable_tf32()


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def _names(path):
    return tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _ref_specs(jtree, m):
    """{path of names: the reference's spec as a tuple}."""
    specs = j_sharding.param_pspecs(jtree, m)
    flat, _ = tree_flatten_with_path(specs,
                                     is_leaf=lambda x: isinstance(x, P))
    return {_names(p): tuple(s) for p, s in flat}


def _port_specs(ttree, m, cfg):
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out[path] = node

    walk(t_sharding.param_pspecs(ttree, m, cfg), ())
    return out


def _site(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def _heads(cfg, top, width):
    if top in ("clip", "clip2"):
        return getattr(cfg, top).heads
    if top == "unet":
        u = cfg.unet
        return width // u.head_dim if u.head_dim else u.num_heads
    return 1


def _divergence(ttree, cfg, m, path, ours, theirs):
    """Why the port's spec of the leaf at ``path`` may differ from the
    reference's, or None where it may not."""
    site = path[:-1]
    node = _site(ttree, site[:-1])
    if any(a and ":" in a for a in ours):
        # the same split dimension, sliced a section at a time
        assert [a and a.split(":")[0] for a in ours] == list(theirs)
        return "GEGLU halves" if site[-1] == "ff1" else "fused sections"
    if ours == () and "w8" in _site(ttree, site):
        return "w8 site"
    if ours == () and "out" in node and any(
            c in node for c in ("q", "k", "v", "qkv", "kv")):
        w = node["out"].get("w", node["out"].get("w_q"))
        if w is not None and _heads(cfg, site[0], w.shape[1]) % m:
            return "heads"
    if ours == () and site[0] in ("vae", "vae_enc"):
        # the VAE's one head of 512 (its q, k, v are 1x1 convs whose biases
        # the reference's rule splits): never whole heads on a rank
        return "the VAE's one head"
    return None


def _compare(ttree, jspecs, cfg, m):
    """{reason: count} of the disagreements; fails on one without a
    listed reason."""
    ours = _port_specs(ttree, m, cfg)
    assert set(ours) == set(jspecs)
    reasons = {}
    for path, theirs in jspecs.items():
        if ours[path] == theirs:
            continue
        why = _divergence(ttree, cfg, m, path, ours[path], theirs)
        assert why is not None, (path, ours[path], theirs)
        reasons[why] = reasons.get(why, 0) + 1
    return reasons


@pytest.mark.parametrize("m,fuse", [(2, False), (4, False), (2, True),
                                    (7, False)])
def test_plan_agrees_with_the_reference_on_tiny(m, fuse):
    """TINY at m = 2 (whole heads: two of two), 4 (heads replicate), a
    fused tree, and the reference's ``model_size=7`` (everything
    replicated in both, ``tests/test_parallel.py:53``)."""
    from sdtpu_torch.io.params import fuse_attention_projections, to_jax_tree

    ttree = trees("tiny")[1]
    if fuse:
        ttree = fuse_attention_projections(ttree)
    jtree = jax.tree.map(jnp.asarray, to_jax_tree(ttree))
    reasons = _compare(ttree, _ref_specs(jtree, m), t_config.TINY, m)
    if m == 7:
        assert reasons == {}
        assert all(s == () for s in _port_specs(ttree, m,
                                                t_config.TINY).values())
    elif m == 4:
        assert set(reasons) <= {"heads", "GEGLU halves",
                                "the VAE's one head"} and "heads" in reasons
    else:
        assert "GEGLU halves" in reasons
        assert ("fused sections" in reasons) == fuse


def _meta_tree(cfg):
    return {name: init_tree(name, cfg, None, "meta")
            for name in tree_names(cfg)}


@pytest.mark.parametrize("name,m", [("sd15", 2), ("sd15", 8), ("sdxl", 4)])
def test_plan_agrees_with_the_reference_at_full_width(name, m):
    """SD1.5 and SDXL's full-width trees: the reference's through
    ``jax.eval_shape`` of its init, the port's on the meta device. CLIP
    ViT-L's 12 heads replicate at m = 8; SDXL's 640-wide level (10 heads of
    64) at m = 4; the int8 weights only at a ``w8`` site."""
    jcfg, tcfg = j_config.CONFIGS[name], t_config.CONFIGS[name]
    jtree = jax.eval_shape(lambda k: j_params.init_pipeline_params(k, jcfg),
                           jax.random.PRNGKey(0))
    ttree = _meta_tree(tcfg)
    reasons = _compare(ttree, _ref_specs(jtree, m), tcfg, m)
    assert "GEGLU halves" in reasons
    assert ("heads" in reasons) == (m > 2)
    plan = t_sharding.site_plan(ttree, m, tcfg)
    rows = {(p[0], p[-1]) for p, (kind, _) in plan.items() if kind == "row"}
    # CLIP's attention replicates at m = 8, its MLP splits
    assert {("unet", "out"), ("unet", "ff2"), ("clip", "fc2")} <= rows
    assert (("clip", "out") in rows) == (m != 8)


def test_plan_keeps_w8_sites_whole():
    """Under ``int8w_dense`` a weight-only-int8 dense site (and its
    partner) is replicated whole: the reference shards only its bias."""
    from sdtpu_torch.io.params import to_jax_tree
    from sdtpu_torch.quant.ptq import quantize_weights_only

    ttree = dict(trees("tiny")[1])
    ttree["unet"] = quantize_weights_only(ttree["unet"], include_dense=True,
                                          min_elems=0)
    jtree = jax.tree.map(jnp.asarray, to_jax_tree(ttree))
    reasons = _compare(ttree, _ref_specs(jtree, 2), t_config.TINY, 2)
    assert reasons.get("w8 site", 0) > 0
    assert not any(p[0] == "unet" for p in t_sharding.site_plan(
        ttree, 2, t_config.TINY))


def test_shard_params_slices_each_section():
    """Rank r's columns of GEGLU's ff1 are the r-th slice of each half, of
    a fused qkv the r-th of each section; a row site's rows the r-th
    chunk; a column-major int8 weight stays column-major; replicated
    leaves are the same tensors."""
    from sdtpu_torch.io.params import fuse_attention_projections
    from sdtpu_torch.quant.ptq import quantize_unet

    full = fuse_attention_projections(trees("tiny")[1])
    st = full["unet"]["down"][0]["blocks"][0]["st"]
    for r in range(2):
        local = t_sharding.shard_params(full, t_mesh.Mesh(1, 2, r),
                                        t_config.TINY)
        lst = local["unet"]["down"][0]["blocks"][0]["st"]
        w, lw = st["ff1"]["w"], lst["ff1"]["w"]
        half, q = w.shape[1] // 2, w.shape[1] // 4
        assert torch.equal(lw, torch.cat(
            [w[:, r * q:(r + 1) * q], w[:, half + r * q:half + (r + 1) * q]],
            dim=1))
        wq, lwq = st["attn1"]["qkv"]["w"], lst["attn1"]["qkv"]["w"]
        c = wq.shape[1] // 3
        assert torch.equal(lwq, torch.cat(
            [wq[:, s * c + r * c // 2:s * c + (r + 1) * c // 2]
             for s in range(3)], dim=1))
        wo = st["attn1"]["out"]["w"]
        assert torch.equal(lst["attn1"]["out"]["w"],
                           wo[r * wo.shape[0] // 2:(r + 1) * wo.shape[0] // 2])
        assert lst["attn1"]["out"]["b"] is st["attn1"]["out"]["b"]
        assert (local["vae"]["conv_in"]["w"]
                is full["vae"]["conv_in"]["w"])
    q8 = quantize_unet(trees("tiny")[1])
    local = t_sharding.shard_params(q8, t_mesh.Mesh(1, 2, 1), t_config.TINY)
    w = local["unet"]["mid"]["st"]["attn1"]["q"]["w_q"]
    assert w.t().is_contiguous() and not w.is_contiguous()


# ---------------------------------------------------------------------------
# the mesh: gloo worlds of CPU processes
# ---------------------------------------------------------------------------

def _lora_file(path):
    """A rank-2 adapter on attn1's q (a column site), its out and ff2 (row
    sites) and ff1 (a column site of two halves), B drawn non-zero."""
    c = Context(config="tiny", steps=1, device="cpu")
    g = torch.Generator().manual_seed(3)
    tree = inject_lora({"unet": c.params["unet"]}, 2, g,
                       targets=("q", "out", "ff1", "ff2"))
    ad = extract_lora(tree)

    def fill(node):
        if isinstance(node, dict):
            return {k: (torch.randn(v.shape, generator=g) * 0.3
                        if k == "lora_b" else fill(v))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [fill(v) for v in node]
        return node

    save_lora_npz(fill(ad)["unet"], path)


TRAIN_KEYS = (20, 21)
SPATIAL_SEED = 13


def _anchor_inputs():
    """The anchors' inputs: tokens, the reference's draws for one key at a
    batch of 2, images and masks; the spatial cases' (latent 8 takes
    ``anchor_generate``'s) and the train step's batch and draws; -> (inputs
    for the ranks, the reference's uncond embedding an anchor)."""
    inputs, j_uncond = {}, {}
    for k, v in _train_batch(t_config.TINY).items():
        inputs[f"train/{k}"] = v
    for i, key in enumerate(TRAIN_KEYS):
        for k, v in _train_draws(jax.random.PRNGKey(key),
                                 t_config.TINY).items():
            inputs[f"train/{i}/{k}"] = v
    for name, cname in ANCHOR_CFG.items():
        tcfg = CFGS[cname][1]
        tok, j_un, _ = _text(cname, b=2)
        inputs[f"{name}/tokens"] = tok
        j_uncond[name] = j_un
        d = _draws(ANCHOR_SEED, _shape(tcfg, b=2), steps=R.ANCHOR_STEPS)
        for k, v in d.items():
            inputs[f"{name}/{k}"] = v
        inputs[f"{name}/image"] = _image(2, seed=11)[1]
        inputs[f"{name}/mask"] = _mask(2)
    for k in ("tokens", "noise"):
        inputs[f"spatial_8/{k}"] = inputs[f"anchor_generate/{k}"]
    inputs["spatial_6/tokens"] = inputs["anchor_generate/tokens"]
    inputs["spatial_6/noise"] = _draws(SPATIAL_SEED, (2, 6, 6, 4),
                                       steps=R.ANCHOR_STEPS)["noise"]
    return inputs, j_uncond


def _reference_spatial(refmod, j_uncond, inputs, anchors):
    """{latent size: (latents, image)} of the reference's single-device
    ``generate`` with the spatial cases' draws: at 8 ``anchor_generate``'s,
    at 6 one more compile of its UNet."""
    mp = pytest.MonkeyPatch()
    try:
        jcfg = dataclasses.replace(CFGS["tiny"][0], latent_size=6)
        six = _reference_latents(
            refmod, mp, refmod.generate, trees("tiny")[0],
            jnp.asarray(inputs["spatial_6/tokens"], jnp.int32),
            j_uncond["anchor_generate"], jax.random.PRNGKey(SPATIAL_SEED),
            jnp.float32(7.5), cfg=jcfg, sampler="dpm",
            steps=R.ANCHOR_STEPS, kernels="xla")
    finally:
        mp.undo()
    return {8: anchors["anchor_generate"], 6: six}


def _reference_train(inputs):
    """The reference's two steps (``test_torch_train._Ref``: its loss and
    gradients, optax's update, the EMA): [(loss, grad norm)] and its state
    after them in the port's layout."""
    from test_torch_train import trees as train_trees

    _, jtree = train_trees(t_config.TINY)
    ref_ = _Ref(jtree["unet"], R.TRAIN_LR, lora=False)
    jbatch = {k: jnp.asarray(inputs[f"train/{k}"])
              for k in ("tokens", "latents")}
    steps = [ref_.step(_train_frozen(jtree), jbatch,
                       jax.random.PRNGKey(key))[:2] for key in TRAIN_KEYS]
    return steps, ref_.expect()


def _reference_anchors(refmod, j_uncond, inputs):
    """{anchor: (latents, image)} of the reference's pipeline functions on
    one device, the same draws."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for name, (_, fn_name, _) in R.ANCHORS.items():
            jcfg = CFGS[ANCHOR_CFG[name]][0]
            jtree = trees(ANCHOR_CFG[name])[0]
            args = [jtree, jnp.asarray(inputs[f"{name}/tokens"], jnp.int32),
                    j_uncond[name], jax.random.PRNGKey(ANCHOR_SEED),
                    jnp.float32(7.5)]
            kw = dict(cfg=jcfg, sampler="dpm", steps=R.ANCHOR_STEPS,
                      kernels="xla")
            if fn_name != "generate":
                args.append(jnp.asarray(inputs[f"{name}/image"]))
                kw["start_step"] = R.ANCHOR_START[fn_name]
            if fn_name == "inpaint":
                args.append(jnp.asarray(inputs[f"{name}/mask"]))
            out[name] = _reference_latents(refmod, mp, getattr(refmod,
                                                               fn_name),
                                           *args, **kw)
    finally:
        mp.undo()
    return out


@pytest.fixture(scope="module")
def worlds(request, tmp_path_factory):
    """Start the gloo worlds, compute the reference's results while they
    run, and collect every rank's results: {"w1": [the single cases],
    "w2": [rank 0, rank 1], "w4":
    [...], "anchors": {...}, "spatial": {...}, "train": ...}. The train
    step's reference runs first: its jit traces the reference's
    ``jax.random.normal`` and models, which the pipeline's ``ref`` fixture
    then replaces for the module."""
    d = tmp_path_factory.mktemp("mesh")
    inputs, j_uncond = _anchor_inputs()
    np.savez(d / "inputs.npz", **inputs)
    _lora_file(d / "lora.npz")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + ([os.environ["PYTHONPATH"]]
                                  if os.environ.get("PYTHONPATH") else [])))
    procs = []
    for world in (1, *WORLDS):
        for rank in range(world):
            log = open(d / f"w{world}_r{rank}.log", "w")
            procs.append((world, rank, log, subprocess.Popen(
                [sys.executable, str(ROOT / "tests" / "torch_mesh_ranks.py"),
                 str(world), str(rank), str(d)], cwd=ROOT, env=env,
                stdout=log, stderr=subprocess.STDOUT)))
    try:
        train_ref = _reference_train(inputs)
        ref = request.getfixturevalue("ref")
        anchors = _reference_anchors(ref, j_uncond, inputs)
        spatial_refs = _reference_spatial(ref, j_uncond, inputs, anchors)
        deadline = time.perf_counter() + RANK_TIMEOUT_S
        for *_, p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        for *_, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    out = {"anchors": anchors, "spatial": spatial_refs, "train": train_ref,
           "dir": d}
    for world, rank, _, p in procs:
        text = (d / f"w{world}_r{rank}.log").read_text()
        assert p.returncode == 0, f"world {world} rank {rank}:\n{text[-3000:]}"
        with np.load(d / f"w{world}_r{rank}.npz") as z:
            out.setdefault(f"w{world}", []).append({k: z[k] for k in z.files})
    return out


def _ranks(worlds, mesh):
    world = next(w for w, ms in WORLDS.items() if mesh in ms)
    return worlds[f"w{world}"]


CASES = ["generate", "generate_negative", "generate_async", "generate_batch",
         "scheduled", "weighted", "img2img", "inpaint", "img2img_batch",
         "inpaint_batch", "hires_fix", "two_stage_base", "two_stage",
         "controlnet", "lora", "pin", "xl", "concat_inpaint9", "ip2p",
         "stream"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_serves_as_one_device(worlds, mesh, case):
    """Each entry point on the mesh within 1 uint8 LSB of the same call on
    a Context without one (float32 latents within 1e-4 of its max-abs);
    every rank returns the same whole batch."""
    ranks = _ranks(worlds, mesh)
    single = worlds["w1"][0][f"single/{case}"]
    got = [r[f"{mesh}/{case}"] for r in ranks]
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    assert got[0].shape == single.shape and got[0].dtype == single.dtype
    if single.dtype == np.uint8:
        assert np.abs(got[0].astype(int) - single.astype(int)).max() <= 1
    else:
        assert_close(got[0], single)


@pytest.mark.parametrize("anchor", sorted(R.ANCHORS))
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_pipeline_matches_jax(worlds, mesh, anchor):
    """The port's pipeline functions on each rank's split tree, with the
    reference's draws, against the reference's single-device result:
    latents within 1e-4 of its max-abs, the images within 1 LSB."""
    j_lat, j_img = worlds["anchors"][anchor]
    for rank in _ranks(worlds, mesh):
        assert_close(rank[f"{mesh}/{anchor}/latent"], j_lat)
        img = rank[f"{mesh}/{anchor}/image"]
        assert img.dtype == np.uint8 and img.shape == j_img.shape
        assert np.abs(img.astype(int) - j_img.astype(int)).max() <= 1


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_indivisible_batch_is_refused_with_the_references_text(worlds, mesh):
    """One prompt on a data axis of 2: ``INVALID_ARGUMENT`` with the
    reference's text (``sdtpu/engine/context.py:817-821``), on every rank
    and before any collective (the ranks go on to their next case)."""
    src = (ROOT / "sdtpu" / "engine" / "context.py").read_text()
    assert 'f"batch {batch} not divisible by data axis "' in src
    for rank in _ranks(worlds, mesh):
        assert str(rank[f"{mesh}/indivisible/error"]) == (
            f"SdtpuError:{ErrorCode.INVALID_ARGUMENT!r}:"
            f"batch 1 not divisible by data axis 2")


@pytest.mark.parametrize("mesh", MESHES)
def test_stream_pool_is_refused_on_a_mesh(worlds, mesh):
    """The stream pool is no longer refused on a mesh: every rank ticks the
    same pool, and each request's image is within 1 uint8 LSB of the same
    request through ``generate_batch`` on that mesh (the pool's contract,
    ``engine/stream.py``)."""
    for rank in _ranks(worlds, mesh):
        pool = rank[f"{mesh}/stream"].astype(int)
        batch = rank[f"{mesh}/stream_batch"].astype(int)
        assert pool.shape == batch.shape
        assert np.abs(pool - batch).max() <= 1


@pytest.mark.parametrize("data,model", [(2, 2), (1, 2), (2, 1)])
def test_mesh_larger_than_the_world_is_refused(data, model):
    """No process group: the world is one rank. ``make_mesh`` raises the
    reference's ``ValueError`` text (its one-device mesh), and the Context
    gives it as ``INVALID_ARGUMENT``."""
    with pytest.raises(ValueError) as theirs:
        j_mesh.make_mesh(data=data, model=model,
                         devices=jax.devices()[:1])
    with pytest.raises(ValueError) as ours:
        t_mesh.make_mesh(data=data, model=model)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(SdtpuError) as ei:
        Context(config="tiny", steps=1, device="cpu", mesh=(data, model))
    assert ei.value.code == ErrorCode.INVALID_ARGUMENT
    assert ei.value.reason == str(theirs.value)


def test_one_rank_without_a_group_serves_with_no_collective():
    """``mesh=(1, 1)`` with no process group (``single_device_mesh``): the
    bytes of a Context without a mesh, no collective issued."""
    a = Context(config="tiny", steps=2, device="cpu")
    b = Context(config="tiny", steps=2, device="cpu", mesh=(1, 1))
    assert b.mesh.shape == {"data": 1, "model": 1} and b.mesh.groups is None
    one = t_mesh.single_device_mesh()
    assert one.shape == b.mesh.shape and one.coords == (0, 0)
    collectives.reset_counts()
    np.testing.assert_array_equal(a.generate(["a", "b"], seed=2),
                                  b.generate(["a", "b"], seed=2))
    assert collectives.collective_counts() == dict.fromkeys(
        collectives.COLLECTIVES, 0)
    assert set(collectives.COLLECTIVES) == {
        "all-reduce", "all-gather", "collective-permute", "reduce-scatter",
        "all-to-all"}


def _plan_counts(m, cfg=t_config.TINY):
    """(all-reduces an eval, an encode; all-gathers a time table) of a rank
    of the model axis, from the plan of TINY's tree."""
    plan = t_sharding.site_plan(trees("tiny")[1], m, cfg)
    rows = [p for p, (kind, _) in plan.items() if kind == "row"]
    gathers = [p for p, (kind, _) in plan.items() if kind == "gather"]
    return (sum(p[0] == "unet" for p in rows),
            sum(p[0] == "clip" for p in rows),
            sum(p[0] == "temb" for p in gathers))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case,steps", [("pin", 1), ("generate", R.STEPS)])
def test_collectives_are_the_plans(worlds, mesh, case, steps):
    """Each rank's collectives for a two-prompt ``generate``: an eval's
    row sites' all-reduces each step, an encode's once (the uncond
    embedding was made at init), the time table's gather, and one gather of
    the images over a data axis of 2; nothing else. TINY at m = 2: 21 an
    eval (7 transformers x 3), 4 an encode (2 CLIP layers x 2), 1 a
    table."""
    data, model = (int(v) for v in mesh.split("x"))
    per_eval, per_encode, per_table = _plan_counts(model)
    if model > 1:
        assert (per_eval, per_encode, per_table) == (21, 4, 1)
    want = dict.fromkeys(collectives.COLLECTIVES, 0)
    want["all-reduce"] = per_eval * steps + per_encode
    want["all-gather"] = per_table + (data > 1)
    for rank in _ranks(worlds, mesh):
        got = dict(zip(collectives.COLLECTIVES,
                       rank[f"{mesh}/{case}/counts"].tolist()))
        assert got == want


def test_lora_overlay_slices_with_its_sites(tmp_path):
    """A LoRA overlay on a rank of m = 2: ``lora_b`` takes its column
    site's columns (both GEGLU halves at ff1), ``lora_a`` its row site's
    rows, ``lora_s`` whole."""
    path = tmp_path / "a.npz"
    _lora_file(path)
    from sdtpu_torch.train.lora import load_lora_npz

    ad = load_lora_npz(path)
    full = trees("tiny")[1]
    plan = t_sharding.site_plan(full, 2, t_config.TINY)
    local = t_sharding.shard_adapter(ad, t_mesh.Mesh(1, 2, 1), plan)
    a, la = ad["down"][0]["blocks"][0]["st"], local["down"][0]["blocks"][0][
        "st"]
    b = a["attn1"]["q"]["lora_b"]
    assert torch.equal(la["attn1"]["q"]["lora_b"], b[:, b.shape[1] // 2:])
    lo = a["attn1"]["out"]["lora_a"]
    assert torch.equal(la["attn1"]["out"]["lora_a"], lo[lo.shape[0] // 2:])
    f = a["ff1"]["lora_b"]
    q = f.shape[1] // 4
    assert torch.equal(la["ff1"]["lora_b"],
                       torch.cat([f[:, q:2 * q], f[:, 3 * q:]], dim=1))
    assert torch.equal(la["ff2"]["lora_s"], a["ff2"]["lora_s"])


def test_dataclass_config_reaches_the_plan():
    """A configuration object's heads decide the plan: TINY with 4 heads
    splits its attentions at m = 4 where TINY's 2 heads replicate."""
    four = dataclasses.replace(t_config.TINY, unet=dataclasses.replace(
        t_config.TINY.unet, num_heads=4))
    tree = init_pipeline_params(four, None, "meta")
    at4 = t_sharding.site_plan(tree, 4, four)
    at4_tiny = t_sharding.site_plan(tree, 4, t_config.TINY)
    assert any(p[-1] == "out" for p in at4 if p[0] == "unet")
    assert not any(p[-1] == "out" for p in at4_tiny if p[0] == "unet")


# ---------------------------------------------------------------------------
# the train step, the spatial partition and serve --mesh
# ---------------------------------------------------------------------------

TRAIN_MESHES = ["1x2", "2x1", "2x2"]
SPATIAL_MESHES = ["1x2", "2x2"]
#: the train step's loss against the reference's (tests/test_train.py:100)
TRAIN_LOSS_RTOL = 2e-5


def _coords(worlds, mesh):
    """[(rank's results, (data, model) coordinates)] of a mesh's ranks."""
    model = int(mesh.split("x")[1])
    return [(r, (i // model, i % model))
            for i, r in enumerate(_ranks(worlds, mesh))]


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
def test_mesh_train_step_matches_the_reference(worlds, mesh):
    """Two steps of ``make_train_step(..., mesh=, plan=)`` on each rank's
    split tree, every rank handed the whole batch and the reference's
    draws, against the reference's single-device step: the loss within
    ``TRAIN_LOSS_RTOL`` and the grad norm (the logical tree's) within
    ``test_torch_train.GRAD_TOL`` each step; after the second, the
    gathered params, AdamW moments and EMA within
    ``test_torch_train._check_state``'s bounds, the same on every rank."""
    steps, want = worlds["train"]
    for rank, _ in _coords(worlds, mesh):
        for i, (jloss, jnorm) in enumerate(steps):
            np.testing.assert_allclose(rank[f"{mesh}/train/{i}/loss"], jloss,
                                       rtol=TRAIN_LOSS_RTOL)
            np.testing.assert_allclose(rank[f"{mesh}/train/{i}/grad_norm"],
                                       jnorm, rtol=1e-4)

        def flat(name):
            pre = f"{mesh}/train/{name}/"
            return {k[len(pre):]: torch.from_numpy(v) for k, v in rank.items()
                    if k.startswith(pre)}

        state = types.SimpleNamespace(
            params=flat("params"), ema=flat("ema"), opt_state={
                "count": torch.tensor(R.TRAIN_STEPS), "mu": flat("mu"),
                "nu": flat("nu")})
        _check_state(state, want, _end_to_end(R.TRAIN_LR, R.TRAIN_STEPS),
                     drift=True)


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
def test_mesh_train_backward_in_another_thread(worlds, mesh):
    """The gradients of a loss on the mesh are the same bits when the
    backward runs in a thread that does not see the call's mesh (as
    autograd's device thread runs a CUDA backward): the collectives'
    backward carries its mesh from the forward."""
    for rank in _ranks(worlds, mesh):
        assert bool(rank[f"{mesh}/train/thread_grads_equal"])


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
def test_mesh_train_keeps_replicated_leaves_the_same_bits(worlds, mesh):
    """After the update every leaf a data group shares is the same bytes on
    its ranks, and every leaf the plan does not split is the same bytes on
    the ranks of a model group; split leaves differ there."""
    ranks = _coords(worlds, mesh)
    split = set(ranks[0][0][f"{mesh}/train/split"].tolist())
    model = int(mesh.split("x")[1])
    assert bool(split) == (model > 1)
    keys = [t_step.flat_key(p)
            for p, _ in t_step.leaves(trees("tiny")[1]["unet"])]
    for a, ca in ranks:
        for b, cb in ranks:
            da, db = (r[f"{mesh}/train/digests"] for r in (a, b))
            if ca[1] == cb[1]:
                np.testing.assert_array_equal(da, db)
            elif ca[0] == cb[0]:
                for k, x, y in zip(keys, da, db):
                    assert (x == y) == (k not in split), k


def test_global_norm_counts_a_replicated_leaf_once(worlds):
    """``global_norm`` at m = 2 of a replicated leaf (ones [3] on both
    ranks) and a split one (halves of arange(4)): sqrt(3 + 14), where
    all-reducing every sum of squares would give sqrt(2 * 3 + 14)."""
    for rank in _ranks(worlds, "1x2"):
        got = float(rank["1x2/global_norm"])
        assert got == pytest.approx(np.sqrt(17.0), rel=1e-6)
        assert got != pytest.approx(np.sqrt(20.0), rel=1e-3)


def _train_pin(data, model):
    """A rank's collectives a train step at TINY: at m > 1 each row site's
    all-reduce forward and its column input's backward (21 each), CLIP's
    4, the global norm's 1, the time table's gather; at d > 1 one gradient
    bucket and the loss."""
    per_eval, per_encode, per_table = _plan_counts(model)
    want = dict.fromkeys(collectives.COLLECTIVES, 0)
    if model > 1:
        want["all-reduce"] = 2 * per_eval + per_encode + 1
        want["all-gather"] = per_table
    if data > 1:
        want["all-reduce"] += len(collectives.buckets(
            [t.numel() for _, t in t_step.leaves(trees("tiny")[1]["unet"])]
        )) + 1
    return want


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
def test_mesh_train_collectives_are_the_plans(worlds, mesh):
    """Each rank's collectives in each train step (``_train_pin``): at
    (1, 2) 47 all-reduces and 1 all-gather, at (2, 1) 2 all-reduces."""
    data, model = (int(v) for v in mesh.split("x"))
    want = _train_pin(data, model)
    if (data, model) == (1, 2):
        assert want["all-reduce"] == 47 and want["all-gather"] == 1
    for rank in _ranks(worlds, mesh):
        for i in range(R.TRAIN_STEPS):
            got = dict(zip(collectives.COLLECTIVES,
                           rank[f"{mesh}/train/{i}/counts"].tolist()))
            assert got == want


def _spatial_eval_counts(u, lat, m):
    """A rank's all-gathers and collective-permutes in one UNet eval of
    config ``u`` at a ``lat``-wide latent under the spatial partition at
    m, from the UNet's structure and ``spatial.tiles``' rule: a halo (two
    permutes) a 3x3 conv on a slice, a GroupNorm's statistics (one
    gather) on a slice, a transformer's plane (one gather), a slice
    gathered where a level stops tiling or a down conv's slice is odd, the
    output (one gather)."""
    def tiles(w):
        return w % m == 0 and w // m >= 2

    n = {"ag": 0, "perm": 0}
    st = {"w": lat, "sp": tiles(lat)}

    def conv3():
        n["perm"] += 2 * st["sp"]

    def res():
        n["ag"] += 2 * st["sp"]
        n["perm"] += 4 * st["sp"]

    def transformer():
        n["ag"] += st["sp"]

    last = len(u.channel_mult) - 1
    conv3()
    for lvl in range(last + 1):
        for _ in range(u.num_res_blocks):
            res()
            if lvl in u.attn_levels:
                transformer()
        if lvl != last:
            if st["sp"] and (st["w"] // m) % 2:
                n["ag"] += 1
                st["sp"] = False
            conv3()
            st["w"] = (st["w"] + 1) // 2
            if st["sp"] and not tiles(st["w"]):
                n["ag"] += 1
            st["sp"] = tiles(st["w"])
    res()
    transformer()
    res()
    for lvl in reversed(range(last + 1)):
        for _ in range(u.num_res_blocks + 1):
            res()
            if lvl in u.attn_levels:
                transformer()
        if lvl:
            st["w"] *= 2
            st["sp"] = tiles(st["w"])
            conv3()
    n["ag"] += 2 * st["sp"]
    conv3()
    return n["ag"], n["perm"]


@pytest.mark.parametrize("lat", sorted(R.SPATIAL))
@pytest.mark.parametrize("mesh", SPATIAL_MESHES)
def test_spatial_collectives_are_the_rule(worlds, mesh, lat):
    """One UNet eval under the spatial partition: the row sites'
    all-reduces (21), and the all-gathers and collective-permutes of
    ``_spatial_eval_counts``: at latent 8, 25 and 40; at 6, where the
    3-wide level stays whole, fewer."""
    model = int(mesh.split("x")[1])
    ag, perm = _spatial_eval_counts(t_config.TINY.unet, lat, model)
    if lat == 8:
        assert (ag, perm) == (25, 40)
    want = dict.fromkeys(collectives.COLLECTIVES, 0)
    want.update({"all-reduce": _plan_counts(model)[0], "all-gather": ag,
                 "collective-permute": perm})
    for rank in _ranks(worlds, mesh):
        got = dict(zip(collectives.COLLECTIVES,
                       rank[f"{mesh}/spatial_{lat}/eval/counts"].tolist()))
        assert got == want


SPATIAL_CASES = [(lat, k) for lat, ks in sorted(R.SPATIAL.items())
                 for k in ks]


@pytest.mark.parametrize("lat,kernels", SPATIAL_CASES)
@pytest.mark.parametrize("mesh", SPATIAL_MESHES)
def test_spatial_matches_jax(worlds, mesh, lat, kernels):
    """``generate_sharded(..., spatial=True)`` on each rank's split tree
    with the reference's draws, against the reference's single-device
    ``generate``: latents within 1e-4 of its max-abs, the images within 1
    uint8 LSB (``tests/test_parallel.py:179``); every rank the same
    bytes."""
    j_lat, j_img = worlds["spatial"][lat]
    imgs = []
    for rank in _ranks(worlds, mesh):
        assert_close(rank[f"{mesh}/spatial_{lat}/{kernels}/latent"], j_lat)
        img = rank[f"{mesh}/spatial_{lat}/{kernels}/image"]
        assert img.dtype == np.uint8 and img.shape == j_img.shape
        assert np.abs(img.astype(int) - j_img.astype(int)).max() <= 1
        imgs.append(img)
    for img in imgs[1:]:
        np.testing.assert_array_equal(img, imgs[0])


def test_spatial_rule_is_the_references():
    """``spatial.tiles`` is the reference's ``constrain`` rule: split
    where W % m == 0 and W // m >= 2; nothing is split with the spec off or
    at m = 1."""
    from sdtpu_torch.parallel import spatial

    src = (ROOT / "sdtpu" / "parallel" / "spatial.py").read_text()
    assert "x.shape[2] % n or x.shape[2] // n < 2" in src
    assert spatial.parts() == 1 and not spatial.tiles(64)
    for m, w, want in ((2, 64, True), (2, 2, False), (2, 4, True),
                       (4, 4, False), (2, 3, False), (4, 8, True)):
        with spatial.use(t_mesh.Mesh(1, m, 0)):
            assert spatial.tiles(w) == want, (m, w)
    with spatial.use(t_mesh.Mesh(2, 1, 0)):
        assert not spatial.tiles(64)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """``python -m sdtpu_torch.cli serve --mesh 1,2`` as a user starts it
    (it starts its follower itself), two requests (/generate through the
    pool, /img2img through the micro-batcher), then SIGINT to the server:
    -> (the two raw answers, the server's exit code, whether any process
    of its session is left)."""
    import base64
    import io

    from PIL import Image

    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + ([os.environ["PYTHONPATH"]]
                                  if os.environ.get("PYTHONPATH") else [])))
    p = subprocess.Popen(
        [sys.executable, "-m", "sdtpu_torch.cli", "serve", "--config",
         "tiny", "--steps", str(R.SERVE_STEPS), "--platform", "cpu",
         "--port", "0", "--mesh", "1,2", "--stream-slots", "2"],
        cwd=tmp_path_factory.mktemp("serve"), env=env,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    lines, ready = [], threading.Event()

    def read():
        for line in p.stderr:
            lines.append(line)
            if "serving on http://" in line:
                ready.set()

    threading.Thread(target=read, daemon=True).start()
    try:
        assert ready.wait(RANK_TIMEOUT_S), "".join(lines)[-3000:]
        url = next(ln for ln in lines if "serving on http://" in ln).split(
            "serving on ")[1].split()[0]
        buf = io.BytesIO()
        Image.fromarray(R.serve_image(t_config.TINY.image_size)).save(
            buf, format="PNG")
        gen = _post(f"{url}/generate", {**R.SERVE_GENERATE, "format": "raw"})
        i2i = _post(f"{url}/img2img", {
            **R.SERVE_IMG2IMG, "strength": R.SERVE_STRENGTH, "format": "raw",
            "image_b64": base64.b64encode(buf.getvalue()).decode()})
        os.kill(p.pid, signal.SIGINT)
        rc = p.wait(timeout=120)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    try:
        os.killpg(p.pid, 0)
        left = True
    except ProcessLookupError:
        left = False
    return gen, i2i, rc, left, "".join(lines)


def test_serve_mesh_answers_as_the_context(worlds, served):
    """``serve --mesh 1,2``'s answers are the bytes of the same requests on
    ``Context(mesh=(1, 2))`` (the pool's and ``img2img_batch``'s), on both
    ranks of the worker world; the server exits 0 on SIGINT, its follower
    with it."""
    gen, i2i, rc, left, log = served
    size = t_config.TINY.image_size
    for rank in _ranks(worlds, "1x2"):
        for got, case in ((gen, "serve_generate"), (i2i, "serve_img2img")):
            want = rank[f"1x2/{case}"]
            assert want.shape == (size, size, 3)
            np.testing.assert_array_equal(
                np.frombuffer(got, np.uint8).reshape(want.shape), want)
    # and the mesh's answer is the one device's within 1 LSB
    single = worlds["w1"][0]["single/serve_generate"].astype(int)
    assert np.abs(np.frombuffer(gen, np.uint8).reshape(single.shape)
                  - single).max() <= 1
    assert rc == 0, log[-3000:]
    assert not left


# ---------------------------------------------------------------------------
# checkpoints on the mesh
# ---------------------------------------------------------------------------

def _writes(worlds, mesh, key):
    return [int(r[f"{mesh}/{key}"]) for r in _ranks(worlds, mesh)]


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_checkpoint_serves_the_demo_bytes(worlds, mesh):
    """The demo Context's split tree saved from the mesh
    (``save_checkpoint``: rank 0 alone opens a file, the first data row
    alone gathers) is the logical tree,
    ``save_native``'s file of a Context without a mesh byte for byte; a
    ``Context(model_dir=, mesh=)`` of it holds the demo Context's split
    tree and plan, and serves its ``generate`` bytes with its
    collectives."""
    from sdtpu_torch.io.checkpoint import CHECKPOINT_FILE
    from sdtpu_torch.io.weights import save_native

    assert _writes(worlds, mesh, "checkpoint/writes") == [1] + [0] * (
        len(_ranks(worlds, mesh)) - 1)
    # the first data row gathers each split leaf once; the other rows
    # gather nothing
    gathers = _writes(worlds, mesh, "checkpoint/save_gathers")
    m = int(mesh.split("x")[1])
    assert gathers[:m] == [gathers[0]] * m and (gathers[0] > 0) == (m > 1)
    assert gathers[m:] == [0] * (len(gathers) - m)
    d = worlds["dir"]
    save_native(Context(config="tiny", steps=R.STEPS, device="cpu").params,
                d / f"native_{mesh}.sdtpu.safetensors")
    assert ((d / f"ck_{mesh}" / CHECKPOINT_FILE).read_bytes()
            == (d / f"native_{mesh}.sdtpu.safetensors").read_bytes())
    for rank in _ranks(worlds, mesh):
        assert bool(rank[f"{mesh}/checkpoint/same_tree"])
        assert bool(rank[f"{mesh}/checkpoint/same_plan"])
        np.testing.assert_array_equal(rank[f"{mesh}/checkpoint/generate"],
                                      rank[f"{mesh}/generate"])
        np.testing.assert_array_equal(
            rank[f"{mesh}/checkpoint/generate/counts"],
            rank[f"{mesh}/generate/counts"])


def _gathered(rank, mesh):
    """{state key: the gathered tensor} of a rank's train state after its
    steps (``gather_params``' params, moments and EMA)."""
    keys = {"params": "params/", "mu": "opt/mu/", "nu": "opt/nu/",
            "ema": "ema/"}
    out = {}
    for name, pre in keys.items():
        head = f"{mesh}/train/{name}/"
        out.update({pre + k[len(head):]: torch.from_numpy(v)
                    for k, v in rank.items() if k.startswith(head)})
    return out


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
def test_mesh_train_state_is_saved_whole(worlds, mesh):
    """The state saved on the mesh (rank 0 alone opens a file) reloads on
    one device as ``gather_params``' state bit for bit, with its count
    and step; a fresh state on the same mesh loaded from it holds each
    rank's own tensors, and one more step from it gives the uninterrupted
    step's bits on every rank."""
    assert _writes(worlds, mesh, "train/writes") == [1] + [0] * (
        len(_ranks(worlds, mesh)) - 1)
    from test_torch_train import trees as train_trees

    ttree, _ = train_trees(t_config.TINY)
    masters = t_step._map(lambda t: t.detach().clone(), ttree["unet"])
    like = t_step.init_train_state(masters, t_step.make_optimizer(),
                                   ema=True)
    t_step.load_train_state(worlds["dir"] / f"ts_{mesh}", like)
    got = t_step._state_tensors(like)
    want = _gathered(_ranks(worlds, mesh)[0], mesh)
    assert set(got) - set(want) == {"opt/count", "step"}
    for k, t in want.items():
        assert torch.equal(got[k], t), k
    assert int(got["opt/count"]) == int(got["step"]) == R.TRAIN_STEPS
    for rank in _ranks(worlds, mesh):
        assert bool(rank[f"{mesh}/train/reload_same"])
        assert bool(rank[f"{mesh}/train/resume_same"])


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
def test_mesh_train_remat_matches_the_step_without(worlds, mesh):
    """Remat on the mesh (ROADMAP item 23c): one step's gradients with the
    UNet's forward recomputed in the backward are the same bits as
    without, and the recompute issues the forward's row-site all-reduces
    again: at m = 2, 21 an eval three times (forward, the column inputs'
    backward, the recompute) and CLIP's 4; the data axis's buckets and
    loss as the step's."""
    data, model = (int(v) for v in mesh.split("x"))
    want = _train_pin(data, model)
    if model > 1:
        per_eval = _plan_counts(model)[0]
        want["all-reduce"] += per_eval - 1   # the recompute; no norm here
    for rank in _ranks(worlds, mesh):
        assert float(rank[f"{mesh}/train/remat_max_abs_diff"]) == 0.0
        got = dict(zip(collectives.COLLECTIVES,
                       rank[f"{mesh}/train/remat/counts"].tolist()))
        assert got == want


def test_mesh_train_state_reloads_on_another_mesh(worlds):
    """The state saved at (1, 2) loads on each rank of (2, 1), where
    nothing is split, as its gathered state, bit for bit."""
    import hashlib

    want = {k: hashlib.sha1(t.contiguous().numpy().tobytes()).hexdigest()
            for k, t in _gathered(_ranks(worlds, "1x2")[0], "1x2").items()}
    for rank in _ranks(worlds, "2x1"):
        got = dict(zip(rank["2x1/train/reload_1x2/keys"].tolist(),
                       rank["2x1/train/reload_1x2/digests"].tolist()))
        assert set(got) - set(want) == {"opt/count", "step"}
        for k, v in want.items():
            assert got[k] == v, k
