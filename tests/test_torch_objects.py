"""The port's object API against the JAX package's.

Objects, paths, scenes and accumulators of ``differt2d_tpu_torch`` are held
against ``differt2d_tpu`` on inputs drawn from one NumPy seed and fed to
both (the port's objects built from the JAX objects' arrays by
``geometry.from_numpy``).  Tolerances: object methods rtol 1e-5 / atol
1e-6 (the same float32 operations); paths, accumulators and maps rtol 1e-4
/ atol 1e-5; pixel gradients of the grid accumulators rtol 1e-3 / atol
1e-5 (``tests/test_torch_tracer.py``'s); Fermat paths under the flip
contract of PARITY.md (at most max(1, 0.5%) of the paths beyond the
tolerance).  Hard-logic results are equal.  Draws from a key are equal bit
for bit (the port's threefry).  The JAX package runs op by op; its
references are computed once per module where tests share them.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt2d_tpu import geometry as jgeom
from differt2d_tpu import tracer as jtracer
from differt2d_tpu.scene import Scene as JScene
from differt2d_tpu.utils import received_power as jreceived_power
from differt2d_tpu_torch import geometry, prng, tracer
from differt2d_tpu_torch.abc import LOCATIONS
from differt2d_tpu_torch.defaults import KIND_RIS, KIND_VERTEX, KIND_WALL
from differt2d_tpu_torch.ops import power_map_kernel as pmk
from differt2d_tpu_torch.scene import SCENE_NAMES, Scene, load_scene_arrays
from differt2d_tpu_torch.utils import received_power

torch.set_num_threads(1)

SEED = 1234
OBJ_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(got, ref, tol=OBJ_TOL):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if ref.dtype == bool:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, **tol)


def _port(obj):
    """The port's object of a JAX object, from its arrays."""
    arrays = {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return geometry.from_numpy(type(obj).__name__, device="cpu", **arrays)


def _port_scene(js: JScene) -> Scene:
    return Scene.from_objects(
        [_port(o) for o in js.objects],
        {k: _port(p) for k, p in js.transmitters.items()},
        {k: _port(p) for k, p in js.receivers.items()},
        device="cpu",
    )


def _pair(cls_name: str, rng):
    """The same random object in both packages."""
    fields = {"Point": {"xy": (2,)}, "Vertex": {"xy": (2,)}, "Ray": {"xys": (2, 2)},
              "Wall": {"xys": (2, 2)}, "RIS": {"xys": (2, 2), "phi": ()}}[cls_name]
    arrays = {k: rng.uniform(0.1, 0.9, size=s).astype(np.float32) for k, s in fields.items()}
    jobj = getattr(jgeom, cls_name)(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return jobj, geometry.from_numpy(cls_name, device="cpu", **arrays)


def _calls(cls_name: str, rng) -> list:
    """``(name, call(obj, array))`` of every method of the class, with
    inputs drawn from ``rng`` (``array`` makes a package's array of a
    NumPy one)."""
    calls = [("bounding_box", lambda o, a: o.bounding_box()),
             ("center", lambda o, a: o.center()),
             ("grid", lambda o, a: o.grid(4, 3))]
    calls += [(f"location {loc}", lambda o, a, loc=loc: o.get_location(loc)) for loc in LOCATIONS]
    if cls_name in ("Ray", "Wall", "RIS"):
        around = rng.uniform(size=2).astype(np.float32)
        calls += [("origin", lambda o, a: o.origin()), ("dest", lambda o, a: o.dest()),
                  ("t", lambda o, a: o.t()),
                  ("rotate", lambda o, a: o.rotate(0.7).xys),
                  ("rotate around xy", lambda o, a: o.rotate(-1.3, around=a(around)).xys)]
    if cls_name in ("Point", "Ray"):
        return calls
    params = rng.uniform(-0.3, 1.3, size=(4, 1)).astype(np.float32)
    carte = rng.uniform(size=(3, 2)).astype(np.float32)
    rays = rng.uniform(size=(6, 2, 2)).astype(np.float32)
    triplets = rng.uniform(size=(3, 3, 2)).astype(np.float32)
    n = 1 if cls_name != "Vertex" else 0
    calls += [("parameters_count", lambda o, a: np.asarray(o.parameters_count()))]
    calls += [(f"parametric_to_cartesian {i}", lambda o, a, p=p: o.parametric_to_cartesian(a(p[:n])))
              for i, p in enumerate(params)]
    calls += [(f"cartesian_to_parametric {i}", lambda o, a, c=c: o.cartesian_to_parametric(a(c)))
              for i, c in enumerate(carte)]
    for approx in (True, False):
        calls += [(f"contains_parametric {i} {approx}",
                   lambda o, a, p=p, approx=approx: o.contains_parametric(a(p[:n]), approx=approx, alpha=30.0))
                  for i, p in enumerate(params)]
        calls += [(f"intersects_cartesian {i} {approx}",
                   lambda o, a, r=r, approx=approx, i=i: o.intersects_cartesian(
                       a(r), patch=0.05 * (i % 2), approx=approx, alpha=30.0))
                  for i, r in enumerate(rays)]
    calls += [(f"evaluate_cartesian {i}", lambda o, a, t=t: o.evaluate_cartesian(a(t)))
              for i, t in enumerate(triplets)]
    calls += [("sample", lambda o, a: o.sample(a(prng.PRNGKey(SEED)) if a is jnp.asarray
                                               else prng.PRNGKey(SEED)))]
    if cls_name in ("Wall", "RIS"):
        calls += [("normal", lambda o, a: o.normal()),
                  ("image_of", lambda o, a: o.image_of(a(carte[0]))),
                  ("vertices", lambda o, a: jnp.stack([v.xy for v in o.get_vertices()])
                   if a is jnp.asarray else torch.stack([v.xy for v in o.get_vertices()]))]
    return calls


def _torch_array(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("cls_name", ["Point", "Vertex", "Ray", "Wall", "RIS"])
def test_object_methods_match_jax(cls_name):
    rng = np.random.default_rng(SEED)
    jobj, tobj = _pair(cls_name, rng)
    for name, call in _calls(cls_name, rng):
        ref, got = call(jobj, jnp.asarray), call(tobj, _torch_array)
        if isinstance(ref, tuple):  # grid
            for g, r in zip(got, ref):
                _close(g, r)
        else:
            try:
                _close(got, ref)
            except AssertionError as exc:
                raise AssertionError(f"{cls_name}.{name}") from exc
    kind = {"Vertex": KIND_VERTEX, "Wall": KIND_WALL, "RIS": KIND_RIS}.get(cls_name)
    assert getattr(tobj, "kind", None) == kind


def test_stack_unstack_closest_point_and_received_power():
    rng = np.random.default_rng(SEED + 1)
    walls = rng.uniform(size=(4, 2, 2)).astype(np.float32)
    jw = [jgeom.Wall(xys=jnp.asarray(w)) for w in walls]
    tw = [geometry.from_numpy("Wall", device="cpu", xys=w) for w in walls]
    _close(geometry.stack_leaves(tw).xys, jgeom.stack_leaves(jw).xys)
    back = geometry.unstack_leaves(geometry.stack_leaves(tw))
    assert [type(w) for w in back] == [geometry.Wall] * 4
    _close(torch.stack([w.xys for w in back]), walls)
    pts, target = walls[:, 0], walls[2, 1]
    ji, jd = jgeom.closest_point(jnp.asarray(pts), jnp.asarray(target))
    ti, td = geometry.closest_point(torch.from_numpy(pts), torch.from_numpy(target))
    assert int(ti) == int(ji)
    _close(td, jd)
    jpath = jgeom.Path(xys=jnp.asarray(walls[:, 0]))
    tpath = geometry.from_numpy("Path", device="cpu", xys=walls[:, 0])
    for kw in ({}, {"r_coef": 0.3, "height": 0.2}):
        _close(received_power(None, None, tpath, [], **kw), jreceived_power(None, None, jpath, [], **kw))
    assert received_power.vectorized


@functools.lru_cache(maxsize=None)
def _scenes() -> dict:
    """The scenes of the path tests, in both packages."""
    out = {}
    for name in ("basic_scene", "square_scene"):
        js = getattr(JScene, name)()
        out[name] = (js, _port_scene(js))
    return out


def _path_kwargs(cls_name):
    return {} if cls_name == "ImagePath" else {"steps": 100}


@functools.lru_cache(maxsize=None)
def _jax_paths(cls_name: str, scene_name: str) -> list:
    """JAX's path, loss, length and validity (soft and hard) of every
    candidate of orders 0-1 from the scene's transmitter to its receiver,
    one key per candidate from ``split(key, total)``."""
    js, _ = _scenes()[scene_name]
    cands = js._np_path_candidates(0, 1)
    keys = jax.random.split(jax.random.PRNGKey(SEED), len(cands))
    cls = getattr(jgeom, cls_name)
    out = []
    for cand, key in zip(cands, keys):
        objs = js.get_interacting_objects(cand)
        path = cls.from_tx_objects_rx(js.transmitters["tx"], objs, js.receivers["rx"], key=key,
                                      **_path_kwargs(cls_name))
        out.append(tuple(np.asarray(v) for v in (
            path.xys, path.loss, path.length(),
            path.is_valid(js.objects, cand, objs, approx=True, alpha=40.0),
            path.is_valid(js.objects, cand, objs, approx=False))))
    return out


@pytest.mark.parametrize("scene_name", ["basic_scene", "square_scene"])
@pytest.mark.parametrize("cls_name", ["ImagePath", "FermatPath", "MinPath"])
def test_path_classes_match_jax(cls_name, scene_name):
    _, ts = _scenes()[scene_name]
    cands = ts._np_path_candidates(0, 1)
    keys = prng.split(prng.PRNGKey(SEED), len(cands))
    cls = getattr(geometry, cls_name)
    refs = _jax_paths(cls_name, scene_name)
    beyond = 0
    for cand, key, ref in zip(cands, keys, refs):
        objs = ts.get_interacting_objects(cand)
        path = cls.from_tx_objects_rx(geometry.Point(xy=ts.transmitters["tx"]), objs,
                                      ts.receivers["rx"], key=key, **_path_kwargs(cls_name))
        got = (path.xys, path.loss, path.length(),
               path.is_valid(ts.objects, cand, objs, approx=True, alpha=40.0),
               path.is_valid(ts.objects, cand, objs, approx=False))
        if cls_name == "FermatPath":
            ok = all(np.allclose(_np(g), r, **TOL) if r.dtype != bool else np.array_equal(_np(g), r)
                     for g, r in zip(got, ref))
            beyond += not ok
            continue
        for g, r in zip(got, ref):
            _close(g, r, TOL)
    # PARITY.md's flip contract for the Fermat solver, on paths.
    assert beyond <= max(1, 0.005 * len(cands)), f"{beyond} of {len(cands)} Fermat paths differ"


def test_midpoint_path_and_parametric_helpers():
    js, ts = _scenes()["basic_scene"]
    rng = np.random.default_rng(SEED + 2)
    theta = rng.uniform(size=3).astype(np.float32)
    cand = np.array([4, 5, 1])
    jobjs, tobjs = js.get_interacting_objects(cand), ts.get_interacting_objects(cand)
    jtx, ttx = js.transmitters["tx"].xy, ts.transmitters["tx"]
    jrx, trx = js.receivers["rx"].xy, ts.receivers["rx"]
    _close(geometry.parametric_to_cartesian(tobjs, torch.from_numpy(theta), 3, ttx, trx),
           jgeom.parametric_to_cartesian(jobjs, jnp.asarray(theta), 3, jtx, jrx))
    _close(geometry.parametric_to_cartesian_from_slice(tobjs[1], torch.from_numpy(theta), 1, 1),
           jgeom.parametric_to_cartesian_from_slice(jobjs[1], jnp.asarray(theta), 1, 1))
    jp = jgeom.Path.from_tx_objects_rx(jtx, jobjs, jrx)
    tp = geometry.Path.from_tx_objects_rx(ttx, tobjs, trx)
    _close(tp.xys, jp.xys)
    for approx in (True, False):
        _close(tp.on_objects(tobjs, approx=approx), jp.on_objects(jobjs, approx=approx))
        _close(tp.intersects_with_objects(ts.objects, torch.from_numpy(cand), approx=approx),
               jp.intersects_with_objects(js.objects, cand, approx=approx))
    _close(tp.bounding_box(), jp.bounding_box())


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_factories_match_jax(name):
    js = JScene.from_scene_name(name)
    ts = Scene.from_scene_name(name, device="cpu")
    arr = jtracer.scene_arrays(js)
    _close(ts.walls, arr.walls)
    assert ts.kinds == tuple(int(k) for k in np.asarray(arr.kind))
    for mine, theirs in ((ts.transmitters, js.transmitters), (ts.receivers, js.receivers)):
        assert list(mine) == list(theirs)
        for k in mine:
            _close(mine[k], theirs[k].xy)


def test_random_uniform_scene_bit_for_bit():
    js = JScene.random_uniform_scene(3, 4, 2, key=jax.random.PRNGKey(SEED))
    ts = Scene.random_uniform_scene(3, 4, 2, key=prng.PRNGKey(SEED), device="cpu")
    np.testing.assert_array_equal(_np(ts.walls), np.asarray(jtracer.scene_arrays(js).walls))
    for mine, theirs in ((ts.transmitters, js.transmitters), (ts.receivers, js.receivers)):
        assert list(mine) == list(theirs)
        for k in mine:
            np.testing.assert_array_equal(_np(mine[k]), np.asarray(theirs[k].xy))


def test_square_scenes_with_wall_and_obstacle_arguments():
    for jname, kwargs in (("square_scene_with_wall", dict(ratio=0.3, tx_coords=(0.1, 0.7))),
                          ("square_scene_with_obstacle", dict(ratio=0.25, rx_coords=(0.9, 0.2)))):
        js = getattr(JScene, jname)(**kwargs)
        ts = getattr(Scene, jname)(device="cpu", **kwargs)
        _close(ts.walls, jtracer.scene_arrays(js).walls)
        _close(ts.transmitters["tx"], js.transmitters["tx"].xy)
        _close(ts.receivers["rx"], js.receivers["rx"].xy)


def test_scene_algebra_matches_jax():
    rng = np.random.default_rng(SEED + 3)
    js, ts = _scenes()["square_scene"]
    ris = rng.uniform(size=(2, 2)).astype(np.float32)
    vert = rng.uniform(size=2).astype(np.float32)
    pts = rng.uniform(size=(3, 2)).astype(np.float32)
    jnew = [jgeom.RIS(xys=jnp.asarray(ris), phi=jnp.asarray(0.3)), jgeom.Vertex(xy=jnp.asarray(vert))]
    tnew = [_port(o) for o in jnew]

    def same(t: Scene, j: JScene):
        arr = jtracer.scene_arrays(j)
        _close(t.walls, arr.walls)
        _close(t.phi, arr.phi)
        assert t.kinds == tuple(int(k) for k in np.asarray(arr.kind))
        assert [type(o).__name__ for o in t.objects] == [type(o).__name__ for o in j.objects]
        for mine, theirs in ((t.transmitters, j.transmitters), (t.receivers, j.receivers)):
            assert list(mine) == list(theirs)
            for k in mine:
                _close(mine[k], theirs[k].xy)

    jp = [jgeom.Point(xy=jnp.asarray(p)) for p in pts]
    tp = [_port(p) for p in jp]
    j2, t2 = js.add_objects(*jnew), ts.add_objects(*tnew)
    same(t2, j2)
    same(t2.with_objects(*tnew, *t2.objects[:2]), j2.with_objects(*jnew, *j2.objects[:2]))
    same(t2.filter_objects(lambda o: isinstance(o, geometry.Wall)),
         j2.filter_objects(lambda o: isinstance(o, jgeom.Wall)))
    same(t2.with_transmitters(a=tp[0], b=tp[1]), j2.with_transmitters(a=jp[0], b=jp[1]))
    same(t2.with_receivers(c=tp[2]), j2.with_receivers(c=jp[2]))
    same(t2.update_transmitters(tx=tp[1], t9=tp[2]), j2.update_transmitters(tx=jp[1], t9=jp[2]))
    same(t2.update_receivers(r2=tp[0]), j2.update_receivers(r2=jp[0]))
    same(t2.rename_transmitters(tx="a"), j2.rename_transmitters(tx="a"))
    same(t2.rename_receivers(rx="z"), j2.rename_receivers(rx="z"))
    same(Scene.from_stacked_objects(ts.stacked_objects()), JScene.from_stacked_objects(js.stacked_objects()))
    _close(ts.get_object(2).xys, js.get_object(2).xys)  # JAX's needs one object class
    assert type(t2.get_object(5)) is geometry.Vertex
    _close(t2.get_object(5).xy, j2.objects[5].xy)
    _close(t2.bounding_box(), j2.bounding_box())
    _close(t2.center(), j2.center())
    many = t2.update_transmitters(t1=tp[0], t2=tp[1])
    jmany = j2.update_transmitters(t1=jp[0], t2=jp[1])
    for what in ("transmitter", "receiver"):
        tname, td = getattr(many, f"get_closest_{what}")(torch.from_numpy(pts[2]))
        jname, jd = getattr(jmany, f"get_closest_{what}")(jnp.asarray(pts[2]))
        assert tname == jname
        _close(td, jd)
    tpairs = [(a, _np(p.xy), b, _np(q.xy)) for (a, p), (b, q) in many.all_transmitter_receiver_pairs()]
    jpairs = [(a, np.asarray(p.xy), b, np.asarray(q.xy))
              for (a, p), (b, q) in jmany.all_transmitter_receiver_pairs()]
    assert [(a, b) for a, _, b, _ in tpairs] == [(a, b) for a, _, b, _ in jpairs]
    for (_, p, _, q), (_, jp_, _, jq) in zip(tpairs, jpairs):
        _close(p, jp_)
        _close(q, jq)
    for kw in (dict(max_order=2), dict(order=1, filter_objects="ris"), dict(min_order=1, max_order=2)):
        tkw, jkw = dict(kw), dict(kw)
        if "filter_objects" in kw:
            tkw["filter_objects"] = lambda o: not isinstance(o, geometry.RIS)
            jkw["filter_objects"] = lambda o: not isinstance(o, jgeom.RIS)
        tc = [_np(c).tolist() for c in t2.all_path_candidates(**tkw)]
        jc = [np.asarray(c).tolist() for c in j2.all_path_candidates(**jkw)]
        assert tc == jc
    assert [type(o).__name__ for o in t2.get_interacting_objects(torch.tensor([5, 4, 0]))] == [
        "Vertex", "RIS", "Wall"]


def test_object_views_copy_nothing_and_keep_autograd():
    """Views index the device rows; ``add_objects`` and ``add_ris`` stack
    tensors, so a tracked RIS phase and wall keep their gradients (cfg5's
    loss builds its scene so)."""
    base = Scene.square_scene(device="cpu")
    phi = torch.tensor(0.6, requires_grad=True)
    xys = torch.tensor([[0.5, 0.3], [0.5, 0.7]], requires_grad=True)
    scene = base.add_objects(geometry.Vertex(xy=torch.tensor([0.2, 0.8]))).add_ris(xys, phi=phi)
    assert scene.kinds == (KIND_WALL,) * 4 + (KIND_VERTEX, KIND_RIS)
    views = scene.objects
    assert views is scene.objects
    assert views[5].xys.data_ptr() == scene.walls[5].data_ptr()
    assert views[5].phi.data_ptr() == scene.phi[5:].data_ptr()
    assert views[4].xy.data_ptr() == scene.walls[4, 0].data_ptr()
    assert tracer._filter_nodes(scene, lambda o: isinstance(o, geometry.RIS)) == (0, 1, 2, 3, 4)
    x = np.linspace(0.05, 0.45, 4, dtype=np.float32)
    X, Y = (torch.from_numpy(a) for a in np.meshgrid(x, np.linspace(0.05, 0.95, 4, dtype=np.float32)))
    Z = tracer.power_map(scene, X, Y, order=1, solver="mpt", steps=30, approx=True,
                         key=prng.PRNGKey(SEED), filter_objects=lambda o: o.kind == KIND_RIS,
                         device="cpu")
    g_phi, g_xys = torch.autograd.grad(Z.sum(), (phi, xys))
    assert bool(torch.isfinite(g_phi)) and float(g_phi.abs()) > 0
    assert bool(torch.isfinite(g_xys).all())


def test_load_scene_arrays_builds_the_same_scene_from_numpy():
    rng = np.random.default_rng(SEED + 4)
    walls = rng.uniform(size=(5, 2, 2)).astype(np.float32)
    kind = np.array([0, 1, 2, 0, 1], np.int32)
    walls[2, 1] = walls[2, 0]  # a vertex stores its location in both ends
    phi = np.where(kind == 1, rng.uniform(size=5), 0.0).astype(np.float32)
    tx, rx = rng.uniform(size=(2, 2)).astype(np.float32)
    objs = []
    for w, k, p in zip(walls, kind, phi):
        if k == KIND_VERTEX:
            objs.append(jgeom.Vertex(xy=jnp.asarray(w[0])))
        elif k == KIND_RIS:
            objs.append(jgeom.RIS(xys=jnp.asarray(w), phi=jnp.asarray(p)))
        else:
            objs.append(jgeom.Wall(xys=jnp.asarray(w)))
    js = JScene(transmitters={"tx": jgeom.Point(xy=jnp.asarray(tx))},
                receivers={"rx": jgeom.Point(xy=jnp.asarray(rx))}, objects=tuple(objs))
    ts = load_scene_arrays(walls, kind, phi, {"tx": geometry.from_numpy("Point", device="cpu", xy=tx)},
                           {"rx": rx}, device="cpu")
    assert [type(o).__name__ for o in ts.objects] == [type(o).__name__ for o in js.objects]
    for t, j in zip(ts.objects, js.objects):
        for f in dataclasses.fields(j):
            _close(getattr(t, f.name), getattr(j, f.name))
    walls_only = load_scene_arrays(walls[:2], device="cpu")
    assert walls_only.kinds == (KIND_WALL, KIND_WALL) and not walls_only.transmitters


def _mpt_scene():
    """Two transmitters, a wall, a RIS: sequential keys cross the pairs."""
    js = JScene.square_scene(rx_coords=(0.25, 0.8)).add_objects(
        jgeom.RIS(xys=jnp.array([[0.5, 0.3], [0.5, 0.7]]))
    ).update_transmitters(tx2=jgeom.Point(xy=jnp.array([0.8, 0.3])))
    return js, _port_scene(js)


@functools.lru_cache(maxsize=None)
def _jax_all_paths() -> list:
    js, _ = _mpt_scene()
    return [(a, b, np.asarray(v), np.asarray(p.xys), np.asarray(p.loss), np.asarray(c))
            for a, b, v, p, c in js.all_paths(
                path_cls=jgeom.MinPath, path_cls_kwargs={"steps": 60}, max_order=1,
                key=jax.random.PRNGKey(SEED), approx=True, alpha=30.0)]


def test_all_paths_split_keys_sequentially_as_jax():
    _, ts = _mpt_scene()
    got = list(ts.all_paths(path_cls=geometry.MinPath, path_cls_kwargs={"steps": 60},
                            max_order=1, key=prng.PRNGKey(SEED), approx=True, alpha=30.0))
    ref = _jax_all_paths()
    assert [(a, b, _np(c).tolist()) for a, b, _, _, c in got] == [
        (a, b, c.tolist()) for a, b, _, _, _, c in ref]
    for (_, _, v, p, _), (_, _, jv, jxys, jloss, _) in zip(got, ref):
        _close(v, jv, TOL)
        _close(p.xys, jxys, TOL)
        _close(p.loss, jloss, TOL)


def test_all_valid_paths_and_accumulate_over_paths_match_jax():
    js, ts = _scenes()["basic_scene"]
    for approx, order in ((False, 1), (True, 1)):
        got = [(a, b, _np(c).tolist(), _np(p.xys)) for a, b, p, c in
               ts.all_valid_paths(approx=approx, max_order=order)]
        ref = [(a, b, np.asarray(c).tolist(), np.asarray(p.xys)) for a, b, p, c in
               js.all_valid_paths(approx=approx, max_order=order)]
        assert [g[:3] for g in got] == [r[:3] for r in ref]
        for g, r in zip(got, ref):
            _close(g[3], r[3], TOL)
    jm, tm = _mpt_scene()
    kw = dict(max_order=1, approx=True, alpha=30.0)
    for reduce_all in (True, False):
        got = tm.accumulate_over_paths(received_power, fun_kwargs={"r_coef": 0.4},
                                       reduce_all=reduce_all, **kw)
        ref = jm.accumulate_over_paths(jreceived_power, fun_kwargs={"r_coef": 0.4},
                                       reduce_all=reduce_all, **kw)
        if reduce_all:
            _close(got, ref, TOL)
        else:
            got, ref = list(got), list(ref)
            assert [g[:2] for g in got] == [r[:2] for r in ref]
            for g, r in zip(got, ref):
                _close(g[2], r[2], TOL)
    # MinPath with sequential keys: the sum of the paths of all_paths.
    total = tm.accumulate_over_paths(received_power, reduce_all=True, path_cls=geometry.MinPath,
                                     path_cls_kwargs={"steps": 60}, key=prng.PRNGKey(SEED), **kw)
    ref = sum(np.asarray(v) * np.asarray(jreceived_power(None, None, jgeom.Path(xys=jnp.asarray(p)), []))
              for _, _, v, p, _, _ in _jax_all_paths())
    _close(total, ref, TOL)


def _grid(nx=5, ny=4):
    x = np.linspace(0.05, 0.95, nx, dtype=np.float32)
    y = np.linspace(0.07, 0.93, ny, dtype=np.float32)
    return np.meshgrid(x, y)


def _general_power(transmitter, receiver, path, interacting_objects, r_coef=0.5, height=0.1):
    """``received_power`` as a function of the user's: the accumulators
    take their general path for it."""
    r = path.length()
    return r_coef ** (path.xys.shape[0] - 2) / (height * height + r * r)


def _run_grid(scene, which, X, Y, fun, mode, **kw):
    call = getattr(scene, f"accumulate_on_{which}_grid_over_paths")
    return call(X, Y, fun, reduce_all=True, grad=mode == "grad",
                value_and_grad=mode == "value_and_grad", **kw)


GRID_KW = dict(max_order=1, approx=True, alpha=50.0)


@functools.lru_cache(maxsize=None)
def _jax_grid_map(which: str):
    """The JAX package's map and pixel gradient of the grid requests: its
    fast grid path is this ``power_map`` call (run here on its XLA tracer:
    on the CPU its kernels run interpreted)."""
    js, _ = _scenes()["basic_scene"]
    Xn, Yn = _grid()
    Z, dZ = jtracer.power_map(js, jnp.asarray(Xn), jnp.asarray(Yn), r_coef=0.4,
                              on_transmitters=which == "transmitters", value_and_grad=True,
                              backend="xla", **GRID_KW)
    return np.asarray(Z), np.asarray(dZ)


@pytest.mark.parametrize("which", ["receivers", "transmitters"])
@pytest.mark.parametrize("path", ["fast", "general"])
def test_grid_accumulators_match_jax(which, path):
    """Values at rtol 1e-4 / atol 1e-5, gradients at rtol 1e-3 / atol
    1e-5; the general path also within JAX's own fast-vs-general
    tolerances (``tests/test_tracer.py``: 2e-5 / 1e-6 and 2e-4 / 1e-5)."""
    _, ts = _scenes()["basic_scene"]
    X, Y = (torch.from_numpy(a) for a in _grid())
    fun = received_power if path == "fast" else _general_power
    Z = _run_grid(ts, which, X, Y, fun, "value", fun_kwargs={"r_coef": 0.4}, **GRID_KW)
    vZ, dZ = _run_grid(ts, which, X, Y, fun, "value_and_grad", fun_kwargs={"r_coef": 0.4},
                       **GRID_KW)
    gZ = _run_grid(ts, which, X, Y, fun, "grad", fun_kwargs={"r_coef": 0.4}, **GRID_KW)
    rZ, rdZ = _jax_grid_map(which)
    for got in (Z, vZ):
        _close(got, rZ, TOL if path == "fast" else dict(rtol=2e-5, atol=1e-6))
    for got in (dZ, gZ):
        _close(got, rdZ, GRAD_TOL if path == "fast" else dict(rtol=2e-4, atol=1e-5))
    if path == "fast":  # the fast path is power_map's map, bit for bit
        ref = tracer.power_map(ts, X, Y, r_coef=0.4, on_transmitters=which == "transmitters",
                               device="cpu", **GRID_KW)
        assert torch.equal(Z, ref)


def _custom_power(transmitter, receiver, path, interacting_objects, scale=1.0):
    """A path function that reads the protocol's arguments."""
    r = path.length()
    d = receiver.xy - transmitter.xy
    return scale * (1.0 + len(interacting_objects)) * (d[0] + 2.0) / (0.01 + r * r)


def test_general_path_hands_points_and_objects_to_fun():
    js, ts = _scenes()["square_scene"]
    Xn, Yn = _grid(2, 2)
    kw = dict(order=1, approx=True, fun_kwargs={"scale": 2.0})
    got = ts.accumulate_on_receivers_grid_over_paths(torch.from_numpy(Xn), torch.from_numpy(Yn),
                                                     _custom_power, reduce_all=True, **kw)
    # Jitted: one compile in place of the general path's op-by-op run.
    ref = jax.jit(lambda X, Y: js.accumulate_on_receivers_grid_over_paths(
        X, Y, _custom_power, reduce_all=True, **kw))(jnp.asarray(Xn), jnp.asarray(Yn))
    _close(got, ref, TOL)


def test_grid_accumulator_iterator_and_solver_general_path():
    """The iterator form with two transmitters on the fast path (the
    unrolled kernel's plain version on the CPU, one launch per map), and
    a MinPath request on the general path (vmap over pixels of the adam
    solve) against the fast path (JAX's tolerances for solver maps)."""
    js, ts = _scenes()["square_scene"]
    js2 = js.update_transmitters(tx2=jgeom.Point(xy=jnp.array([0.7, 0.8])))
    ts2 = _port_scene(js2)
    Xn, Yn = _grid(4, 3)
    X, Y = torch.from_numpy(Xn), torch.from_numpy(Yn)
    kw = dict(max_order=1, approx=True)
    got = list(ts2.accumulate_on_receivers_grid_over_paths(X, Y, received_power, **kw))
    ref = list(js2.accumulate_on_receivers_grid_over_paths(jnp.asarray(Xn), jnp.asarray(Yn),
                                                            jreceived_power, **kw))
    assert [n for n, _ in got] == [n for n, _ in ref] == ["tx", "tx2"]
    for (_, g), (_, r) in zip(got, ref):
        _close(g, r, TOL)
    mpt = dict(reduce_all=True, path_cls=geometry.MinPath, path_cls_kwargs={"steps": 40},
               key=prng.PRNGKey(SEED), order=1, approx=True,
               filter_objects=lambda o: int(o.xys[0, 0] * 4) % 2 == 0)
    fast = ts.accumulate_on_receivers_grid_over_paths(X, Y, received_power, **mpt)
    general = ts.accumulate_on_receivers_grid_over_paths(
        X, Y, lambda *a: received_power(*a), **mpt)
    _close(general, fast, dict(rtol=2e-4, atol=1e-5))
    assert float(fast.sum()) > 0


@functools.lru_cache(maxsize=None)
def _jax_trace_paths() -> dict:
    js, _ = _mpt_scene()
    out = {}
    for solver, key in (("image", None), ("mpt", jax.random.PRNGKey(SEED))):
        res = jtracer.trace_paths(js, js.transmitters["tx2"].xy, js.receivers["rx"].xy,
                                  max_order=1, solver=solver, key=key, approx=True, steps=20)
        out[solver] = {o: {k: np.asarray(v) for k, v in d.items()} for o, d in res.items()}
    return out


@pytest.mark.parametrize("solver", ["image", "mpt"])
def test_trace_paths_matches_jax(solver):
    _, ts = _mpt_scene()
    key = None if solver == "image" else prng.PRNGKey(SEED)
    got = tracer.trace_paths(ts, ts.transmitters["tx2"], ts.receivers["rx"], max_order=1,
                             solver=solver, key=key, approx=True, steps=20, device="cpu")
    ref = _jax_trace_paths()[solver]
    assert sorted(got) == sorted(ref)
    for o in ref:
        np.testing.assert_array_equal(_np(got[o]["candidates"]), ref[o]["candidates"])
        for name in ("points", "loss", "valid"):
            _close(got[o][name], ref[o][name], TOL)


def test_fast_grid_gates_follow_jax():
    """Requests outside ``_try_fast_grid``'s gates take the general path
    (no kernel-route launch counted on the CPU either: the plain versions
    do not count), those inside reach ``power_map``."""
    _, ts = _scenes()["basic_scene"]
    X, Y = (torch.from_numpy(a) for a in _grid(3, 2))
    calls = []
    real = tracer.power_map

    def spy(*a, **k):
        calls.append(k)
        return real(*a, **k)

    tracer.power_map = spy
    try:
        for kwargs, fast in (({}, True), ({"path_cls_kwargs": {"steps": 5, "many": 1}}, True),
                             ({"fun_kwargs": {"r_coef": 0.2, "height": 0.3}}, True),
                             ({"fun_args": (0.5,)}, False), ({"receiver_cls": geometry.Vertex}, False),
                             ({"fun_kwargs": {"other": 1}}, False),
                             ({"path_cls_kwargs": {"implicit": True}}, False),
                             ({"path_cls": geometry.Path}, False)):
            fun = received_power if "fun_args" not in kwargs else (
                lambda t, r, p, o, extra: received_power(t, r, p, o) * extra)
            if "fun_kwargs" in kwargs and "other" in kwargs["fun_kwargs"]:
                fun = lambda t, r, p, o, other: received_power(t, r, p, o)  # noqa: E731
            n = len(calls)
            extra = {"key": prng.PRNGKey(0)} if "path_cls_kwargs" in kwargs else {}
            if kwargs.get("path_cls_kwargs", {}).get("implicit"):
                kwargs = dict(kwargs, path_cls=geometry.MinPath)
            ts.accumulate_on_receivers_grid_over_paths(X, Y, fun, reduce_all=True, approx=True,
                                                       **extra, **kwargs)
            assert (len(calls) > n) == fast, kwargs
    finally:
        tracer.power_map = real
    assert pmk.LAUNCHES["power_map_value"] == 0
