"""The port's closed-loop evaluation (vla_adapter_torch/eval/) against the
JAX package's, on the CPU, with scripted environments (neither LIBERO nor
CALVIN is installed):

* the policy resize without TensorFlow (a subprocess where ``import
  tensorflow`` fails) against the JAX package's TensorFlow pixels, bit for
  bit, and a static scan that the serving and eval modules import no
  TensorFlow;
* robot_utils and both open-loop controllers bit for bit;
* the replay fixtures of tests/test_replay.py reproduced by the port's
  harness, and the enriched-language swap;
* eval_libero in both packages against one in-process ``libero``
  stand-in (result dicts, per-task rates, the episode-level fault
  tolerance, the rollout videos) and regenerate_libero.main on a raw
  HDF5 file;
* the tiny VLA through run_episode and rollout_subtask with the JAX
  Predictor and the port's (fp32, 1e-4);
* parity_check: a golden action the JAX tool records from a JAX-exported
  tiny checkpoint, checked by the port's tool; verify_smoke on it.
"""

import ast
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.test_replay as replay
from tests.test_torch_modules import JCFG, TCFG, jax_params
from vla_adapter_tpu.data import normalization as jnorm
from vla_adapter_tpu.eval import calvin as jcalvin
from vla_adapter_tpu.eval import libero as jlibero
from vla_adapter_tpu.eval import openloop as jopen
from vla_adapter_tpu.eval import regenerate_libero as jregen
from vla_adapter_tpu.eval import robot_utils as jru
from vla_adapter_torch.eval import calvin as tcalvin
from vla_adapter_torch.eval import libero as tlibero
from vla_adapter_torch.eval import openloop as topen
from vla_adapter_torch.eval import regenerate_libero as tregen
from vla_adapter_torch.eval import robot_utils as tru

ROOT = Path(__file__).resolve().parent.parent
ATOL = RTOL = 1e-4


def _smooth(shape, seed):
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    phase = np.random.default_rng(seed).uniform(0, 6, size=3)
    chans = [128 + 100 * np.sin(yy / 9.0 + xx / 13.0 + p) for p in phase]
    return np.stack(chans, -1).clip(0, 255).astype(np.uint8)


def _noise(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=(*shape, 3),
                                                dtype=np.uint8)


RESIZE_SHAPES = [(256, 256), (200, 200), (84, 84), (180, 320)]


# --- the policy resize without TensorFlow -----------------------------------------

def test_prepare_image_without_tensorflow_matches_jax(tmp_path):
    """The port's prepare_image in a process where TensorFlow cannot be
    imported equals the JAX package's (TensorFlow here), bit for bit, on
    smooth and noise images at LIBERO's, CALVIN's and a non-square size,
    with and without the 0.9 center crop."""
    from vla_adapter_tpu.data.image_processing import prepare_image

    images = {f"{kind}{i}": fn(shape, i)
              for i, shape in enumerate(RESIZE_SHAPES)
              for kind, fn in (("smooth", _smooth), ("noise", _noise))}
    np.savez(tmp_path / "in.npz", **images)
    code = f"""
import sys
sys.modules["tensorflow"] = None  # import tensorflow fails
import numpy as np
from vla_adapter_torch.data.image_processing import prepare_image
imgs = dict(np.load({str(tmp_path / 'in.npz')!r}))
out = {{}}
for k, v in imgs.items():
    out[k] = prepare_image(v, 224)
    out[k + "_crop"] = prepare_image(v, 224, center_crop_scale=0.9)
assert "tensorflow" not in {{m.split(".")[0] for m in sys.modules
                            if sys.modules[m] is not None}}
np.savez({str(tmp_path / 'out.npz')!r}, **out)
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = dict(np.load(tmp_path / "out.npz"))
    for key, img in images.items():
        for crop, suffix in ((None, ""), (0.9, "_crop")):
            want = prepare_image(img, 224, center_crop_scale=crop)
            assert got[key + suffix].shape == (224, 224, 3)
            np.testing.assert_array_equal(got[key + suffix], want,
                                          err_msg=key + suffix)


SERVING_AND_EVAL = ["data/image_processing.py", "infer/predict.py",
                    "parallel/sharding.py",
                    *(f"eval/{p.name}" for p in sorted(
                        (ROOT / "vla_adapter_torch" / "eval").glob("*.py")))]


def test_serving_and_eval_modules_import_no_tensorflow():
    """A static scan of every import, at any depth, of the serving path's
    preprocessing, the Predictor and the eval modules: no TensorFlow, no
    JAX, no JAX package."""
    bad = []
    for rel in SERVING_AND_EVAL:
        tree = ast.parse((ROOT / "vla_adapter_torch" / rel).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{rel}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in ("tensorflow", "tensorflow_datasets",
                                           "jax", "flax", "vla_adapter_tpu")]
    assert len(SERVING_AND_EVAL) >= 13 and not bad, bad


# --- robot utilities and controllers --------------------------------------------

def test_robot_utils_match_jax():
    rng = np.random.default_rng(0)
    for shape in ((7,), (8, 7), (3, 8, 7)):
        a = rng.uniform(-0.5, 1.5, size=shape)
        a[..., -1] = rng.choice([0.0, 0.5, 1.0, 0.3, 0.7], size=shape[:-1])
        for name in ("normalize_gripper_action", "invert_gripper_action",
                     "process_action"):
            got, want = getattr(tru, name)(a), getattr(jru, name)(a)
            assert got.dtype == want.dtype == np.float64
            np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(
            tru.normalize_gripper_action(a, binarize=False),
            jru.normalize_gripper_action(a, binarize=False))
    for q in (rng.normal(size=4), np.array([0, 0, 0, 1.0]),
              np.array([0.1, 0.2, 0.3, 1.5]), np.array([1.0, 0, 0, 0])):
        np.testing.assert_array_equal(tru.quat2axisangle(q),
                                      jru.quat2axisangle(q))
    img = _noise((40, 52), 1)
    np.testing.assert_array_equal(tru.rotate_180(img), jru.rotate_180(img))
    np.testing.assert_array_equal(tru.resize_image_for_policy(img, 28),
                                  jru.resize_image_for_policy(img, 28))
    tru.set_seed_everywhere(11)
    a = (np.random.rand(3), torch.rand(3))
    jru.set_seed_everywhere(11)
    b = (np.random.rand(3), torch.rand(3))
    np.testing.assert_array_equal(a[0], b[0])
    assert torch.equal(a[1], b[1])


def _chunk_policy(seed):
    rng = np.random.default_rng(seed)
    return lambda *obs: rng.normal(size=(8, 7))


@pytest.mark.parametrize("open_loop", [8, 5])
def test_action_queue_matches_jax(open_loop):
    got = topen.ActionQueueController(_chunk_policy(3), open_loop)
    want = jopen.ActionQueueController(_chunk_policy(3), open_loop)
    for t in range(30):
        if t == 17:
            got.reset()
            want.reset()
        np.testing.assert_array_equal(got.step(t), want.step(t))


def test_temporal_ensemble_matches_jax():
    assert topen._HI3_SCHEDULE == jopen._HI3_SCHEDULE
    assert topen.HI3_CYCLE_LEN == jopen.HI3_CYCLE_LEN == 10
    got = topen.TemporalEnsembleController(_chunk_policy(4))
    want = jopen.TemporalEnsembleController(_chunk_policy(4))
    for t in range(35):
        if t == 23:
            got.reset()
            want.reset()
        np.testing.assert_array_equal(got.step(t), want.step(t))


# --- the replay fixtures and the enriched language ------------------------------

@pytest.fixture
def port_replay(monkeypatch):
    """tests/test_replay.py's recorders driving the port's harness."""
    for name, val in (("run_episode", tlibero.run_episode),
                      ("LiberoEvalConfig", tlibero.LiberoEvalConfig),
                      ("CalvinEvalConfig", tcalvin.CalvinEvalConfig),
                      ("CalvinPolicy", tcalvin.CalvinPolicy),
                      ("rollout_subtask", tcalvin.rollout_subtask)):
        monkeypatch.setattr(replay, name, val)
    return replay


@pytest.mark.parametrize("name", ["libero_replay.json", "calvin_replay.json"])
def test_port_reproduces_the_replay_fixtures(port_replay, name):
    record = (port_replay.record_libero_trace if name.startswith("libero")
              else port_replay.record_calvin_trace)
    golden = json.loads((replay.FIXTURES / name).read_text())
    assert record() == golden


def test_enriched_language_swap():
    """The port's packaged table is the JAX package's, and enrich_lang
    replaces the standard instructions with each task's first
    paraphrase."""
    src = ROOT / "vla_adapter_tpu/eval/assets/enrich_lang_annotations.json"
    dst = ROOT / "vla_adapter_torch/eval/assets/enrich_lang_annotations.json"
    assert dst.read_bytes() == src.read_bytes()
    table = tcalvin.load_enriched_annotations()
    assert table == jcalvin.load_enriched_annotations() and len(table) == 34
    seen = []

    class Recording(replay.FakePredictor):
        def predict_action(self, images, instruction, proprio=None,
                           unnorm_key=None):
            seen.append(instruction)
            return super().predict_action(images, instruction,
                                          proprio=proprio,
                                          unnorm_key=unnorm_key)

    def run(enrich):
        seen.clear()
        env = replay.ScriptedCalvinEnv()
        env.reset = lambda **kw: None
        chains = [({"robot_obs": np.zeros(15), "scene_obs": np.zeros(24)},
                   ["rotate_red_block_right"])]
        res = tcalvin.eval_calvin(
            Recording(), (env, replay.ScriptedOracle(env),
                          {"rotate_red_block_right": ["standard wording"]},
                          chains),
            tcalvin.CalvinEvalConfig(ep_len=5, enrich_lang=enrich))
        assert res["num_chains"] == 1 and res["avg_seq_len"] == 1.0
        return set(seen)

    assert run(False) == {"standard wording"}
    assert run(True) == {"Turn the red block to the right"}


# --- eval_libero and regenerate_libero against a libero stand-in ----------------

class StandInEnv:
    """OffScreenRenderEnv's surface: 256-px seeded frames, eef pose and
    gripper qpos; success at a step fixed by the task and initial state;
    task 1's episode from initial state 1 fails with an error at step 14
    (``fault_at``)."""

    instances = []
    fault_at = {(1, 1): 14}

    def __init__(self, bddl_file_name, camera_heights, camera_widths):
        self.bddl, self.size = bddl_file_name, camera_heights
        self.task = int(Path(bddl_file_name).stem[-1])
        self.seeded, self.closed = None, False
        self.actions = []
        StandInEnv.instances.append(self)

    def seed(self, s):
        self.seeded = s

    def reset(self):
        self.t = 0

    def set_init_state(self, state):
        self.init = int(np.asarray(state).reshape(-1)[0])
        self.t = 0
        return self._obs()

    def get_observation(self):
        return self._obs()

    def get_sim_state(self):
        return np.array([self.t, self.init], np.float64)

    def _obs(self):
        seed = 1000 * self.task + 10 * self.init + self.t
        return {"agentview_image": _noise((self.size, self.size), seed),
                "robot0_eye_in_hand_image": _smooth((self.size, self.size),
                                                    seed),
                "robot0_eef_pos": np.array([0.1, 0.2, 0.01 * self.t]),
                "robot0_eef_quat": np.array([0.0, 0.1, 0.0, 0.99]),
                "robot0_gripper_qpos": np.array([0.04, -0.04])}

    def step(self, action):
        self.t += 1
        self.actions.append(list(np.asarray(action, np.float64)))
        if self.fault_at.get((self.task, self.init)) == self.t:
            raise RuntimeError("simulator fault")
        done = self.t == 12 + 3 * self.task + self.init
        return self._obs(), 0.0, done, {}

    def close(self):
        self.closed = True


def _libero_stand_in(n_tasks=2):
    task = lambda i: types.SimpleNamespace(  # noqa: E731
        language=f"put the bowl number {i} away", problem_folder="fold",
        bddl_file=f"task{i}", name=f"TASK_{i}")

    class Suite:
        def __init__(self):
            self.n_tasks = n_tasks

        def get_task(self, i):
            return task(i)

        def get_task_init_states(self, i):
            return [np.array([k]) for k in range(3)]

    libero = types.ModuleType("libero")
    pkg = types.ModuleType("libero.libero")
    bench = types.ModuleType("libero.libero.benchmark")
    envs = types.ModuleType("libero.libero.envs")
    bench.get_benchmark_dict = lambda: {"libero_spatial": Suite}
    envs.OffScreenRenderEnv = StandInEnv
    pkg.benchmark, pkg.envs = bench, envs
    pkg.get_libero_path = lambda kind: f"/{kind}"
    libero.libero = pkg
    return {"libero": libero, "libero.libero": pkg,
            "libero.libero.benchmark": bench, "libero.libero.envs": envs}


def _imageio_stand_in(written):
    """imageio's get_writer, recording the frames (no video codec here)."""
    class Writer:
        def __init__(self, path, fps):
            self.path, self.fps, self.frames = Path(path), fps, []

        def __enter__(self):
            return self

        def append_data(self, frame):
            self.frames.append(np.array(frame))

        def __exit__(self, *exc):
            written[self.path.name] = (self.fps, np.stack(self.frames))
            self.path.write_bytes(b"mp4")

    mod = types.ModuleType("imageio")
    mod.get_writer = lambda path, fps: Writer(path, fps)
    return mod


def _image_policy(obs, task):
    """A chunk from the prepared images' and state's statistics: the
    executed actions depend on every prepared pixel's sum."""
    full = obs["full_image"].astype(np.float64)
    wrist = obs["wrist_image"].astype(np.float64)
    assert full.shape == wrist.shape == (224, 224, 3)
    base = np.array([full.mean(), wrist.mean(), full.std(), wrist.std(),
                     *obs["state"][:2], len(task)])
    k = np.arange(8)[:, None]
    chunk = np.sin(base[None, :] / 37.0 + 0.3 * k)
    chunk[:, -1] = (full.mean() + 7 * k[:, 0]) % 2 > 1.0
    return chunk


def test_eval_libero_matches_jax(monkeypatch, tmp_path):
    results, traces, videos = {}, {}, {}
    for name, mod in (("jax", jlibero), ("port", tlibero)):
        for key, val in _libero_stand_in().items():
            monkeypatch.setitem(sys.modules, key, val)
        videos[name] = {}
        monkeypatch.setitem(sys.modules, "imageio",
                            _imageio_stand_in(videos[name]))
        StandInEnv.instances = []
        cfg = mod.LiberoEvalConfig(num_trials_per_task=2, save_videos=True,
                                   video_dir=str(tmp_path / name))
        results[name] = mod.eval_libero(_image_policy, cfg)
        traces[name] = [e.actions for e in StandInEnv.instances]
        assert all(e.closed and e.seeded == 0 and e.size == 256
                   for e in StandInEnv.instances)
    assert results["port"] == results["jax"]
    assert traces["port"] == traces["jax"]
    res = results["port"]
    # task 1's second episode raised: counted as a failure, the run went on
    assert (res["episodes"], res["successes"]) == (4, 3)
    assert res["per_task"] == {"put the bowl number 0 away": 1.0,
                               "put the bowl number 1 away": 0.5}
    assert set(videos["port"]) == set(videos["jax"]) == {
        f"task{t}-ep{e}-succ=True-put_the_bowl_number_{t}_away.mp4"
        for t, e in ((0, 0), (0, 1), (1, 0))}
    for file, (fps, frames) in videos["port"].items():
        assert fps == 30 and (tmp_path / "port" / file).exists()
        np.testing.assert_array_equal(frames, videos["jax"][file][1])


def test_eval_libero_needs_the_simulator(monkeypatch):
    monkeypatch.setitem(sys.modules, "libero", None)
    with pytest.raises(ImportError, match="libero"):
        tlibero.eval_libero(_image_policy, tlibero.LiberoEvalConfig())


def test_regenerate_libero_matches_jax(monkeypatch, tmp_path):
    import h5py

    for key, val in _libero_stand_in().items():
        monkeypatch.setitem(sys.modules, key, val)
    monkeypatch.setattr(StandInEnv, "fault_at", {})
    raw = tmp_path / "raw"
    raw.mkdir()
    rng = np.random.default_rng(0)
    for t in range(2):
        with h5py.File(raw / f"TASK_{t}_demo.hdf5", "w") as f:
            for d in range(3):
                n = 12 + 3 * t + d + (4 if d == 2 else 0)
                acts = rng.normal(size=(n + 3, 7))
                # three no-ops: no move, the gripper as before; the replay
                # of n actions succeeds but for demo 2 (4 too many)
                for i in (1, 4, 5):
                    acts[i, :-1] = 0.0
                    acts[i, -1] = acts[i - 1, -1]
                g = f.create_group(f"data/demo_{d}")
                g["actions"] = acts
                g["states"] = np.full((n, 2), float(d))
    files = {}
    for name, mod in (("jax", jregen), ("port", tregen)):
        out = tmp_path / name
        mod.main(["--raw_data_dir", str(raw), "--target_dir", str(out)])
        files[name] = {}
        for path in sorted(out.glob("*.hdf5")):
            with h5py.File(path, "r") as f:
                f.visititems(lambda k, v: files[name].__setitem__(
                    f"{path.name}/{k}", np.array(v))
                    if isinstance(v, h5py.Dataset) else None)
    assert files["port"].keys() == files["jax"].keys()
    assert {k.split("/")[2] for k in files["port"]} == {"demo_0", "demo_1"}
    for key, val in files["port"].items():
        np.testing.assert_array_equal(val, files["jax"][key], err_msg=key)
    assert tregen.is_noop(np.zeros(7), None)
    assert not tregen.is_noop(np.r_[np.zeros(6), 1.0], np.zeros(7))


# --- the tiny VLA in the loops, JAX Predictor against the port's ----------------

def _stats():
    rng = np.random.default_rng(0)
    one = lambda: jnorm.dataset_statistics(  # noqa: E731
        rng.uniform(-2, 3, size=(500, 7)), proprio=rng.normal(size=(500, 8)),
        action_mask=[True] * 6 + [False])
    return {"libero_spatial_no_noops": one(), "calvin_abc_rlds": one()}


@pytest.fixture(scope="module")
def tiny_predictors():
    from vla_adapter_tpu.data.tokenization import MockTokenizer as JaxTok
    from vla_adapter_tpu.infer.predict import Predictor as JaxPredictor
    from vla_adapter_tpu.models.layers import FP32_RUNTIME as JAX_FP32
    from vla_adapter_torch.data.tokenization import MockTokenizer
    from vla_adapter_torch.infer.predict import Predictor
    from vla_adapter_torch.models.layers import FP32_RUNTIME
    from vla_adapter_torch.weights.from_jax import from_jax_params

    params = jax_params()
    jtok, ttok = JaxTok(), MockTokenizer()
    jax_pred = JaxPredictor(cfg=JCFG, params=params,
                            tokenize=lambda t: jtok(t).input_ids,
                            norm_stats=_stats(), rt=JAX_FP32,
                            center_crop=True)
    port_pred = Predictor(cfg=TCFG, params=from_jax_params(params, TCFG),
                          tokenize=lambda t: ttok(t).input_ids,
                          norm_stats=_stats(), rt=FP32_RUNTIME,
                          center_crop=True, device="cpu")
    return {"jax": jax_pred, "port": port_pred}


class ActionDrivenEnv:
    """Success once the executed |x| deltas sum past a threshold, so that
    the step count follows the policy's actions; 40-px frames from the
    step and the position."""

    def __init__(self, threshold):
        self.threshold = threshold

    def reset(self):
        self.t, self.x, self.actions = 0, 0.0, []

    def set_init_state(self, state):
        return self._obs()

    def _obs(self):
        seed = self.t + int(1000 * abs(self.x)) % 97
        return {"agentview_image": _smooth((40, 40), seed),
                "robot0_eye_in_hand_image": _noise((40, 40), seed),
                "robot0_eef_pos": np.array([self.x, 0.1, 0.2]),
                "robot0_eef_quat": np.array([0.0, 0.0, 0.0, 1.0]),
                "robot0_gripper_qpos": np.array([0.03, -0.03])}

    def step(self, action):
        self.t += 1
        self.actions.append(np.asarray(action, np.float64))
        if self.t > jlibero.NUM_STEPS_WAIT:
            self.x += abs(float(action[0]))
        return self._obs(), 0.0, abs(self.x) > self.threshold, {}


def test_tiny_vla_through_run_episode_matches_jax(tiny_predictors):
    out = {}
    for name, mod in (("jax", jlibero), ("port", tlibero)):
        pred = tiny_predictors[name]
        env = ActionDrivenEnv(threshold=60.0)
        cfg = mod.LiberoEvalConfig(image_size=28)

        def policy(obs, task):
            return pred.predict_action(
                [obs["full_image"], obs["wrist_image"]], task,
                proprio=obs["state"], unnorm_key="libero_spatial_no_noops")

        ok, frames = mod.run_episode(env, "pick up the cup", policy, cfg,
                                     initial_state=np.zeros(1))
        out[name] = (ok, len(frames), np.asarray(env.actions))
    assert out["port"][:2] == out["jax"][:2]
    assert out["port"][0] and out["port"][1] > 16  # three queries or more
    np.testing.assert_allclose(out["port"][2], out["jax"][2], atol=ATOL,
                               rtol=RTOL)


class CalvinActionEnv:
    def __init__(self):
        self.t, self.x, self.actions = 0, 0.0, []

    def get_obs(self):
        seed = self.t + int(1000 * abs(self.x)) % 89
        return {"rgb_obs": {"rgb_static": _smooth((200, 200), seed),
                            "rgb_gripper": _noise((84, 84), seed)},
                "robot_obs": np.linspace(-1, 1, 15) + 0.1 * self.x}

    def get_info(self):
        return {"x": self.x}

    def step(self, action):
        self.t += 1
        self.actions.append(np.asarray(action, np.float64))
        self.x += abs(float(action[0]))
        return self.get_obs(), 0.0, False, {"x": self.x}


class XOracle:
    def get_task_info_for_set(self, start, info, subtasks):
        return subtasks if info["x"] - start["x"] > 6.0 else set()


def test_tiny_vla_through_calvin_policy_matches_jax(tiny_predictors):
    out = {}
    for name, mod in (("jax", jcalvin), ("port", tcalvin)):
        env = CalvinActionEnv()
        cfg = mod.CalvinEvalConfig(ep_len=3)
        ok = mod.rollout_subtask(env, mod.CalvinPolicy(
            tiny_predictors[name], cfg), XOracle(), "open_drawer",
            "open the drawer", cfg)
        out[name] = (ok, len(env.actions), np.asarray(env.actions))
    assert out["port"][:2] == out["jax"][:2]
    assert out["port"][1] > 3  # past the first hi3 cycle's queries
    np.testing.assert_allclose(out["port"][2], out["jax"][2], atol=ATOL,
                               rtol=RTOL)


# --- parity_check and verify_smoke ----------------------------------------------

@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The tiny VLA exported by the JAX package, and a canned observation
    (40-px frames, so the tools' resize runs)."""
    from vla_adapter_tpu.weights.export import export_checkpoint_dir

    tmp = tmp_path_factory.mktemp("parity")
    ckpt = export_checkpoint_dir(jax_params(), JCFG, tmp / "ckpt",
                                 norm_stats=_stats())
    obs = tmp / "obs.npz"
    np.savez(obs, full_image=_noise((40, 40), 1),
             wrist_image=_smooth((40, 40), 2),
             state=np.random.default_rng(3).normal(size=8))
    return ckpt, obs


def test_parity_check_port_passes_a_jax_golden(exported, monkeypatch,
                                               tmp_path, capsys):
    import functools

    import vla_adapter_tpu.data.tokenization as jtok
    import vla_adapter_tpu.weights.load as jload
    from vla_adapter_tpu.eval import parity_check as jparity
    from vla_adapter_tpu.models.layers import FP32_RUNTIME as JAX_FP32
    from vla_adapter_torch.eval import parity_check as tparity

    ckpt, obs = exported
    # the JAX tool in fp32, with the mock tokenizer (no tokenizer files)
    monkeypatch.setattr(jtok, "load_qwen_tokenizer",
                        lambda path: jtok.MockTokenizer())
    monkeypatch.setattr(jload, "load_vla",
                        functools.partial(jload.load_vla, rt=JAX_FP32))
    golden = tmp_path / "golden.json"
    common = ["--ckpt_dir", str(ckpt), "--obs", str(obs), "--instruction",
              "put the bowl on the plate", "--unnorm_key",
              "libero_spatial_no_noops"]
    jparity.main(["--mode", "record", "--out", str(golden), *common])
    port = [*common, "--device", "cpu", "--dtype", "float32",
            "--mock_tokenizer", "true"]
    capsys.readouterr()
    tparity.main(["--mode", "check", "--golden", str(golden), "--atol",
                  "1e-4", *port])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["parity"] == "PASS" and line["max_abs_diff"] <= 1e-4
    # the port's own record, read back: the same file format, 0.0
    mine = tmp_path / "mine.json"
    tparity.main(["--mode", "record", "--out", str(mine), *port])
    assert json.loads(mine.read_text()).keys() == \
        json.loads(golden.read_text()).keys()
    tparity.main(["--mode", "check", "--golden", str(mine), "--atol", "0",
                  *port])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "max_abs_diff"] == 0.0
    # a golden off by more than atol fails
    bad = json.loads(golden.read_text())
    bad["action"][0][0] += 1e-3
    golden.write_text(json.dumps(bad))
    with pytest.raises(SystemExit):
        tparity.main(["--mode", "check", "--golden", str(golden), "--atol",
                      "1e-4", *port])


def test_verify_smoke_on_the_cpu(exported):
    from vla_adapter_torch.eval import verify_smoke

    ckpt, _ = exported
    times = verify_smoke.main(["--ckpt_dir", str(ckpt), "--device", "cpu",
                               "--mock_tokenizer", "true", "--iters", "2",
                               "--unnorm_key", "calvin_abc_rlds"])
    assert len(times) == 2 and all(t > 0 for t in times)


def test_eval_cli_configs_parse():
    from vla_adapter_torch.core.cli import parse_config
    from vla_adapter_torch.eval.calvin_eval import CalvinCLIConfig
    from vla_adapter_torch.eval.libero_eval import LiberoCLIConfig
    from vla_adapter_torch.eval.parity_check import ParityConfig
    from vla_adapter_torch.eval.regenerate_libero import RegenerateConfig
    from vla_adapter_torch.eval.verify_smoke import VerifyConfig

    cfg = parse_config(LiberoCLIConfig, ["--ckpt_dir", "/x",
                                         "--eval.task_suite_name",
                                         "libero_goal", "--act_int8", "true"])
    assert cfg.eval.task_suite_name == "libero_goal" and cfg.act_int8
    assert cfg.device == "cuda"
    assert parse_config(CalvinCLIConfig, ["--eval.num_sequences", "10"]
                        ).eval.num_sequences == 10
    assert parse_config(VerifyConfig, ["--iters", "2"]).iters == 2
    assert parse_config(ParityConfig, ["--dtype", "float32"]).dtype == \
        "float32"
    assert parse_config(RegenerateConfig, ["--task_suite", "libero_10"]
                        ).task_suite == "libero_10"


# --- chip_smoke.py's phase-18 checks on the CPU --------------------------------

@pytest.fixture
def cpu_sync(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def test_chip_smoke_eval_checks_pass_on_the_tiny_vla(tiny_predictors,
                                                     cpu_sync):
    """Phase 18's LIBERO and CALVIN runs and their checks (queries per
    episode and per ten steps, executed actions from directly returned
    chunks) on the tiny VLA on the CPU, where no kernel launches."""
    import chip_smoke

    pred = tiny_predictors["port"]
    rec, launches = chip_smoke.eval_libero_run(pred, "fp32", {}, "cpu")
    assert launches == {} and rec["queries"] == 12
    assert rec["prepare_observation_host_ms_per_step"] > 0
    rec, launches = chip_smoke.calvin_run(pred, "fp32", {}, "cpu")
    assert rec["queries"] == 51 and rec["env_steps"] == 156
    assert rec["result"]["avg_seq_len"] == 1.0


@pytest.mark.parametrize("where", ["libero", "calvin"])
def test_chip_smoke_eval_checks_catch_a_planted_fault(tiny_predictors,
                                                      cpu_sync, monkeypatch,
                                                      where):
    """An action pipeline that moves the executed action by 1e-6 fails
    the checks."""
    import chip_smoke

    mod = tlibero if where == "libero" else tcalvin
    honest = mod.process_action
    monkeypatch.setattr(mod, "process_action",
                        lambda a: honest(a) + 1e-6)
    run = (chip_smoke.eval_libero_run if where == "libero"
           else chip_smoke.calvin_run)
    with pytest.raises(AssertionError, match="executed action"):
        run(tiny_predictors["port"], "fp32", {}, "cpu")
