"""FedState checkpoints across the two packages: a file the JAX package
writes (``repro.checkpoint``) loads in the port (``repro_torch.checkpoint``)
and the other way round.  Float32 leaves come back bitwise, bfloat16
leaves byte for byte (both packages write them as numpy's raw ``V2``),
``round`` as a 0-d int32.  The port's trainer writes its async run's
state in the same format."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import leaf_to_torch, np_bits_tree
from repro import checkpoint as jck
from repro.core import fed as jfed
from repro_torch import checkpoint as tck
from repro_torch import tree as T
from repro_torch.core import FedState, fed_init
from repro_torch.core.fed import FedConfig


def _np_state(seed=0, C=3):
    """A FedState with float32 and bfloat16 leaves, nested dicts and a
    list, and per-client state, as numpy (bfloat16 as uint16 bits)."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    bf16 = lambda *s: f32(*s).astype(jnp.bfloat16).view(np.uint16)
    W = {"embed": bf16(16, 8), "norm": f32(8),
         "blocks": [{"w": bf16(8, 8), "b": f32(8)}, {"w": bf16(8, 8),
                                                    "b": f32(8)}]}
    like = lambda t: {"embed": t(16, 8), "norm": f32(8),
                      "blocks": [{"w": t(8, 8), "b": f32(8)},
                                 {"w": t(8, 8), "b": f32(8)}]}
    cs = {"comp": {"err": {k: (np.stack([x] * C) if not isinstance(x, list)
                               else [{kk: np.stack([vv] * C)
                                      for kk, vv in d.items()} for d in x])
                           for k, x in like(bf16).items()}}}
    return dict(W=W, M=like(bf16), V=like(bf16), round=7, client_state=cs)


def _to_jax_state(d):
    to = lambda x: jnp.asarray(x.view(jnp.bfloat16) if x.dtype == np.uint16
                               else x)
    return jfed.FedState(W=jax.tree.map(to, d["W"]),
                         M=jax.tree.map(to, d["M"]),
                         V=jax.tree.map(to, d["V"]),
                         round=jnp.asarray(d["round"], jnp.int32),
                         client_state=jax.tree.map(to, d["client_state"]))


def _to_torch_state(d):
    to = lambda t: T.tree_map(leaf_to_torch, t)
    return FedState(W=to(d["W"]), M=to(d["M"]), V=to(d["V"]),
                    round=d["round"], client_state=to(d["client_state"]))


def _zeros_like(state: FedState) -> FedState:
    return state._replace(round=0, **{
        k: T.tree_map(torch.zeros_like, getattr(state, k))
        for k in ("W", "M", "V", "client_state")})


def _raw(x) -> np.ndarray:
    """The bytes of a leaf: a tensor, a JAX array or a loaded npz array."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.element_size() == 2 else x
        return x.numpy().view(np.uint8)
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _assert_same_bytes(port_state: FedState, other):
    """Every leaf of ``port_state`` byte-identical to ``other``'s (a JAX
    FedState, or the dict JAX's loader returns)."""
    other = other._asdict() if hasattr(other, "_asdict") else other
    for name in ("W", "M", "V", "client_state"):
        a, b = T.leaves(getattr(port_state, name)), \
            jax.tree.leaves(other[name])
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            np.testing.assert_array_equal(_raw(x), _raw(y), err_msg=name)
    assert int(np.asarray(other["round"])) == int(port_state.round)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    d = _np_state()
    js = _to_jax_state(d)
    jck.save_fed_state(js, tmp_path / "ck", meta={"from": "jax"})
    like = _zeros_like(_to_torch_state(d))
    ts = tck.load_fed_state(like, tmp_path / "ck")
    assert ts.round == 7 and isinstance(ts.round, int)
    assert ts.W["embed"].dtype == torch.bfloat16
    assert ts.W["norm"].dtype == torch.float32
    _assert_same_bytes(ts, js)


def test_port_checkpoint_loads_in_jax(tmp_path):
    d = _np_state(seed=1)
    ts = _to_torch_state(d)
    tck.save_fed_state(ts, tmp_path / "ck", meta={"from": "port"})
    data = np.load(tmp_path / "ck.npz")
    assert data["round"].dtype == np.int32 and data["round"].shape == ()
    assert data["W/embed"].dtype == np.dtype("V2")
    assert "W/blocks/1/w" in data.files
    loaded = jck.load_fed_state(_to_jax_state(_np_state(seed=2)),
                                tmp_path / "ck")
    _assert_same_bytes(ts, loaded)
    # and back into the port: a round trip
    _assert_same_bytes(tck.load_fed_state(_zeros_like(ts), tmp_path / "ck"),
                       loaded)


def test_trainer_checkpoint_is_the_jax_layout(tmp_path, capsys):
    """The port's async trainer on the smoke starcoder2 saves a FedState
    that the JAX package loads into its own trainer's state, and a JAX
    state of that model loads back into the port."""
    from repro.configs import get_config as jget, reduce_for_smoke as jred
    from repro.models import init_params as jinit
    from repro_torch.launch import train
    path = tmp_path / "ck"
    state, mets = train.main([
        "--arch", "starcoder2-3b", "--smoke", "--rounds", "2", "--device",
        "cpu", "--async-buffer", "2", "--churn-drop-prob", "0.3",
        "--checkpoint", str(path)])
    out = capsys.readouterr().out
    assert "[train] async: 2 server steps, " in out
    assert f"[train] saved {path}" in out
    jcfg = jred(jget("starcoder2-3b"))
    jfc = jfed.FedConfig(n_clients=4)
    jlike = jfed.fed_init(jfc, jinit(jcfg, jax.random.PRNGKey(0)))
    loaded = jck.load_fed_state(jlike, path)
    _assert_same_bytes(state, loaded)
    assert int(loaded.round) == mets["server_steps"] == 2
    # a JAX state of the same model loads into the port's
    jck.save_fed_state(jlike, tmp_path / "j")
    back = tck.load_fed_state(_zeros_like(state), tmp_path / "j")
    _assert_same_bytes(back, jlike)
    assert np.array_equal(np_bits_tree(jlike.W)["embed"],
                          back.W["embed"].view(torch.int16).numpy()
                          .view(np.uint16))
    assert fed_init(FedConfig(n_clients=4), back.W).client_state is None
