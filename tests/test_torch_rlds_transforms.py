"""The port's numpy RLDS transforms against the JAX package's tf ones.

* Every entry of ``OXE_STANDARDIZATION_TRANSFORMS``, one case each, on a
  seeded synthetic raw trajectory holding the keys its transform reads:
  floats within 1e-6, integers, bools and strings exactly (DROID's camera
  swap is a random draw on both sides: either order).
* The gripper helpers on hand-written sequences, and ``quat_to_euler``
  (1e-6).
* The lanczos3 resize against ``tf.image.resize`` at 256->224, 128->224
  and non-square shapes, and each augmentation's apply function against
  ``tf.image`` with the same parameters: crop-and-resize, brightness and
  contrast within 1e-6; saturation and hue (an HSV round trip in fp32)
  within 1/255 before the final rounding and one uint8 level after it.
  The draws are checked for their ranges, seeding and the pad-mask guard.
* ``make_oxe_dataset_kwargs`` and ``get_oxe_dataset_kwargs_and_weights``:
  equal dicts, a standardize function compared by the registry name that
  holds it.
"""

import zlib

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from vla_adapter_torch.data import normalization as tnorm  # noqa: E402
from vla_adapter_torch.data.rlds import obs_transforms as tobs  # noqa: E402
from vla_adapter_torch.data.rlds.oxe import materialize as tmat  # noqa: E402
from vla_adapter_torch.data.rlds.oxe import transforms as tox  # noqa: E402
from vla_adapter_tpu.data import normalization as jnorm  # noqa: E402
from vla_adapter_tpu.data.rlds import obs_transforms as jobs  # noqa: E402
from vla_adapter_tpu.data.rlds.oxe import materialize as jmat  # noqa: E402
from vla_adapter_tpu.data.rlds.oxe import transforms as jox  # noqa: E402

T = 9


def _strings(rng, n, words=("pick", "place", "the", "cup", "open")):
    return np.array([" ".join(rng.choice(words, 3)).encode()
                     for _ in range(n)], dtype=object)


def _zlib_rows(rng, n, width):
    return np.array([zlib.compress(rng.normal(size=width).astype(np.float32)
                                   .tobytes()) for _ in range(n)],
                    dtype=object)


def _codepoints(text: str, width: int = 24):
    row = np.zeros(width, np.int32)
    row[:len(text)] = [ord(c) for c in text]
    return row


def raw_trajectory(action_kind: str, seed: int = 0,
                   nested: bool = False) -> dict:
    """Every observation key any transform reads, at widths every slice
    fits, the action in the form ``action_kind`` names, and with
    ``nested`` the other top-level dicts (DROID's ``action_dict``, ASU's
    ``ground_truth_states``; the Bridge transforms slice every top-level
    key, so they take none)."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=(T, *shape)).astype(np.float32)  # noqa: E731
    grip = rng.uniform(-1, 1, size=(T, 1)).astype(np.float32)
    obs = {
        "state": f(40), "robot_obs": f(15), "robot_state": f(15),
        "end_effector_cartesian_pos": f(7), "end_effector_pose": f(5),
        "cartesian_position": f(6), "gripper_position": np.abs(f(1)),
        "natural_language_instruction": _strings(rng, T),
        "image_with_depth": np.array([b"d%d" % i for i in range(T)], object),
        "depth": rng.integers(0, 255, size=(T, 4, 4, 1)).astype(np.uint16),
        "depth_additional_view": rng.integers(
            0, 255, size=(T, 4, 4, 1)).astype(np.uint16),
        "depth_image": f(4, 4, 1),
        "clip_function_input/base_pose_tool_reached": _zlib_rows(rng, T, 7),
        "gripper_closed": _zlib_rows(rng, T, 1),
        "instruction": np.stack([_codepoints(t) for t in (
            ["push the red star", "move the blue cube"] * T)[:T]]),
        "position": f(2), "yaw": f(1), "eef_pose": f(7),
        "state_gripper_pose": f(), "tcp_base": f(6), "gripper_width": f(),
        "exterior_image_1_left": np.array([b"a%d" % i for i in range(T)],
                                          object),
        "exterior_image_2_left": np.array([b"b%d" % i for i in range(T)],
                                          object),
    }
    traj = {"observation": obs, "language_instruction": _strings(rng, T)}
    if nested:
        traj["ground_truth_states"] = {"EE": f(6)}
        traj["action_dict"] = {"cartesian_velocity": f(6),
                               "gripper_position": np.abs(f(1))}
    if action_kind.startswith("array"):
        width = int(action_kind[5:])
        act = f(width)
        act[:, -1] = rng.uniform(-0.2, 1.2, size=T)  # gripper in/out of [0, 1]
        act[:, -2] = rng.choice([0.0, 0.02, 0.5, 0.97, 1.0], size=T)
        traj["action"] = act
    elif action_kind in ("grip2d", "grip1d"):
        g = np.where(grip > 0.5, 1.0, np.where(grip < -0.5, -1.0, 0.0))
        traj["action"] = {"world_vector": f(3), "rotation_delta": f(3),
                          "gripper_closedness_action": (
                              g if action_kind == "grip2d" else g[:, 0]
                          ).astype(np.float32),
                          "open_gripper": rng.random(T) > 0.5}
    elif action_kind == "taco":
        traj["action"] = {"rel_actions_world": f(7)}
    elif action_kind == "bc_z":
        traj["action"] = {"future/xyz_residual": f(30),
                          "future/axis_angle_residual": f(30),
                          "future/target_close": rng.integers(
                              0, 2, size=(T, 10)).astype(np.int64)}
    elif action_kind == "rh20t":
        traj["action"] = {"tcp_base": f(6), "gripper": f()}
    else:
        raise ValueError(action_kind)
    return traj


# the action form each transform reads (default: an (T, 8) array)
ACTION_KIND = {
    "bridge_oxe_dataset_transform": "grip2d",
    "rt1_dataset_transform": "grip2d",
    "kuka_dataset_transform": "grip2d",
    "taco_play_dataset_transform": "taco",
    "jaco_play_dataset_transform": "grip2d",
    "berkeley_cable_routing_dataset_transform": "grip2d",
    "roboturk_dataset_transform": "grip2d",
    "nyu_door_opening_dataset_transform": "grip2d",
    "viola_dataset_transform": "grip1d",
    "berkeley_autolab_ur5_dataset_transform": "grip1d",
    "toto_dataset_transform": "grip1d",
    "language_table_dataset_transform": "array2",
    "pusht_dataset_transform": "grip1d",
    "bc_z_dataset_transform": "bc_z",
    "uiuc_d3field_dataset_transform": "array3",
    "berkeley_fanuc_dataset_transform": "array6",
    "gnm_dataset_transform": "array2",
    "rh20t_dataset_transform": "rh20t",
}


def _to_tf(tree):
    if isinstance(tree, dict):
        return {k: _to_tf(v) for k, v in tree.items()}
    return tf.constant(tree)


def _to_np(tree):
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    return tree.numpy() if hasattr(tree, "numpy") else np.asarray(tree)


def assert_tree_close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_tree_close(got[k], want[k], f"{path}/{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, (path, g.shape, w.shape)
    if w.dtype.kind == "f":
        assert g.dtype == w.dtype, (path, g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=path)
    else:
        assert g.tolist() == w.tolist(), path


@pytest.mark.parametrize("name", sorted(tox.OXE_STANDARDIZATION_TRANSFORMS))
def test_standardization_transform_matches_jax(name):
    tfn = tox.OXE_STANDARDIZATION_TRANSFORMS[name]
    jfn = jox.OXE_STANDARDIZATION_TRANSFORMS[name]
    kind = ACTION_KIND.get(tfn.__name__, "array8")
    raw = raw_trajectory(kind, seed=len(name),
                         nested=not name.startswith("bridge"))
    want = _to_np(jfn(_to_tf(raw)))
    got = tfn(raw)
    if name == "droid":  # the cameras swap by a coin flip on either side
        obs = want["observation"]
        if got["observation"]["exterior_image_1_left"].tolist() != \
                obs["exterior_image_1_left"].tolist():
            obs["exterior_image_1_left"], obs["exterior_image_2_left"] = (
                obs["exterior_image_2_left"], obs["exterior_image_1_left"])
    assert_tree_close(got, want)
    assert np.asarray(got["action"]).shape[0] in (T, T - 2)


def test_registry_covers_every_dataset_config():
    from vla_adapter_torch.data.rlds.oxe.configs import OXE_DATASET_CONFIGS

    assert set(tox.OXE_STANDARDIZATION_TRANSFORMS) == \
        set(jox.OXE_STANDARDIZATION_TRANSFORMS)
    assert set(OXE_DATASET_CONFIGS) <= set(tox.OXE_STANDARDIZATION_TRANSFORMS)


GRIPPER_SEQUENCES = [
    [0.0, 0.5, 0.97, 1.0, 0.3, 0.02, 0.6, 0.7],
    [0.5, 0.5, 0.5],
    [1.0, 0.2, 0.04],
    [0.9, 0.8, 0.96, 0.5],
]
REL_SEQUENCES = [
    [0.0, 0.0, 0.5, 0.0, -0.5, 0.0, 0.05],
    [0.0, 0.0, 0.0],
    [-1.0, 0.0, 1.0, 1.0],
    [0.0, 0.2, -0.09, -0.3],
]


@pytest.mark.parametrize("seq", GRIPPER_SEQUENCES)
def test_binarize_gripper(seq):
    a = np.asarray(seq, np.float32)
    got = tox.binarize_gripper(a)
    np.testing.assert_array_equal(got, jox.binarize_gripper(
        tf.constant(a)).numpy())
    np.testing.assert_array_equal(got, jnorm.binarize_gripper_actions(a))
    # in-between values take the next definite one; a trailing run the raw
    # last value
    if seq == GRIPPER_SEQUENCES[0]:
        np.testing.assert_allclose(got, [0, 1, 1, 1, 0, 0, 0.7, 0.7],
                                   rtol=0, atol=1e-7)


@pytest.mark.parametrize("seq", REL_SEQUENCES)
def test_rel2abs_gripper(seq):
    a = np.asarray(seq, np.float32)
    got = tox.rel2abs_gripper(a)
    np.testing.assert_array_equal(got, jox.rel2abs_gripper(
        tf.constant(a)).numpy())
    np.testing.assert_array_equal(got, jnorm.rel2abs_gripper_actions(a))
    if seq == REL_SEQUENCES[0]:  # closing first, so it starts open
        assert got.tolist() == [1, 1, 0, 0, 1, 1, 1]


def test_gripper_helpers_of_the_normalization_module():
    a = np.asarray([0.2, 0.9, 0.0], np.float32)
    np.testing.assert_array_equal(tnorm.invert_gripper_actions(a),
                                  jnorm.invert_gripper_actions(a))
    rng = np.random.default_rng(0)
    acts, states = rng.normal(size=(6, 7)), rng.normal(size=(6, 8))
    np.testing.assert_array_equal(tnorm.relabel_bridge_actions(acts, states),
                                  jnorm.relabel_bridge_actions(acts, states))
    assert tnorm.statistics_cache_key("a", "b") == \
        jnorm.statistics_cache_key("a", "b")


def test_dataset_statistics_files(tmp_path):
    stats = {"x": tnorm.dataset_statistics(np.ones((4, 7)))}
    tnorm.save_dataset_statistics(stats, tmp_path / "t.json")
    jnorm.save_dataset_statistics(stats, tmp_path / "j.json")
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    assert tnorm.load_dataset_statistics(tmp_path / "j.json") == stats


def test_quat_to_euler():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    got = tox.quat_to_euler(q)
    want = jox.quat_to_euler(tf.constant(q)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the identity rotation and a quarter turn about z
    np.testing.assert_allclose(
        tox.quat_to_euler(np.array([[0, 0, 0, 1.0],
                                    [0, 0, np.sqrt(0.5), np.sqrt(0.5)]])),
        [[0, 0, 0], [0, 0, np.pi / 2]], atol=1e-12)


# --- resize and augmentation ---------------------------------------------------


@pytest.mark.parametrize("src,dst", [
    ((256, 256), (224, 224)), ((128, 128), (224, 224)),
    ((200, 320), (224, 224)), ((64, 48), (28, 28)), ((224, 224), (224, 224))])
def test_resize_matches_tf(src, dst):
    img = np.random.default_rng(sum(src)).integers(
        0, 256, size=(*src, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tobs.resize_image(img, dst),
                                  jobs.resize_image(img, dst).numpy())
    want = tf.image.resize(tf.cast(img, tf.float32), dst, method="lanczos3",
                           antialias=True).numpy()
    np.testing.assert_allclose(tobs.resize_lanczos3(img, dst), want, rtol=0,
                               atol=1e-6 * 255)


@pytest.fixture(scope="module")
def unit_image():
    return np.random.default_rng(2).random((48, 40, 3), dtype=np.float32)


def test_crop_and_resize_matches_tf(unit_image):
    y, x, h, w = 3, 2, 43, 36
    want = tf.image.resize(
        tf.image.crop_to_bounding_box(unit_image, y, x, h, w), (48, 40),
        method="lanczos3", antialias=True).numpy()
    np.testing.assert_allclose(tobs.crop_and_resize(unit_image, y, x, h, w),
                               want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("value", [-0.2, 0.07, 0.2])
def test_brightness_matches_tf(unit_image, value):
    np.testing.assert_allclose(
        tobs.adjust_brightness(unit_image, value),
        tf.image.adjust_brightness(unit_image, value).numpy(), rtol=0,
        atol=1e-6)


@pytest.mark.parametrize("factor", [0.8, 1.0, 1.17])
def test_contrast_matches_tf(unit_image, factor):
    np.testing.assert_allclose(
        tobs.adjust_contrast(unit_image, factor),
        tf.image.adjust_contrast(unit_image, factor).numpy(), rtol=0,
        atol=1e-6)


def _hsv_bounds(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1 / 255)
    g = np.round(np.clip(got, 0, 1) * 255).astype(int)
    w = np.round(np.clip(want, 0, 1) * 255).astype(int)
    assert np.abs(g - w).max() <= 1


@pytest.mark.parametrize("factor", [0.8, 0.95, 1.2])
def test_saturation_matches_tf(unit_image, factor):
    _hsv_bounds(tobs.adjust_saturation(unit_image, factor),
                tf.image.adjust_saturation(unit_image, factor).numpy())


@pytest.mark.parametrize("delta", [-0.05, 0.013, 0.05])
def test_hue_matches_tf(unit_image, delta):
    _hsv_bounds(tobs.adjust_hue(unit_image, delta),
                tf.image.adjust_hue(unit_image, delta).numpy())


def test_hsv_edge_colors_match_tf():
    """Greys, primaries and ties between channels (the branch edges)."""
    px = np.array([[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0],
                   [0, 1, 0], [0, 0, 1], [1, 1, 0], [0, 1, 1], [1, 0, 1],
                   [0.2, 0.2, 0.7], [0.7, 0.2, 0.2], [0.3, 0.7, 0.7]],
                  np.float32)[None]
    for f in (0.8, 1.2):
        _hsv_bounds(tobs.adjust_saturation(px, f),
                    tf.image.adjust_saturation(px, f).numpy())
    for d in (-0.05, 0.05):
        _hsv_bounds(tobs.adjust_hue(px, d),
                    tf.image.adjust_hue(px, d).numpy())


AUG = dict(random_resized_crop=dict(scale=[0.9, 0.9], ratio=[1.0, 1.0]),
           random_brightness=[0.2], random_contrast=[0.8, 1.2],
           random_saturation=[0.8, 1.2], random_hue=[0.05],
           augment_order=["random_resized_crop", "random_brightness",
                          "random_contrast", "random_saturation",
                          "random_hue"])


def test_augment_draws_ranges_and_seeding():
    """The crop of the recipe (0.9 of the area, square) at 224: 213 px,
    its corner in [0, 11]; uniform draws within their ranges; a seed
    reproduces its image, other seeds and cameras differ; a padding camera
    is left alone."""
    seeds = [(t, 5) for t in range(200)]
    crops = [tobs.draw_crop(s, (224, 224), [0.9, 0.9], [1.0, 1.0])
             for s in seeds]
    assert {(h, w) for _, _, h, w in crops} == {(213, 213)}
    ys = np.array([y for y, _, _, _ in crops])
    assert ys.min() == 0 and ys.max() == 10
    b = np.array([tobs._uniform(s, -0.2, 0.2) for s in seeds])
    assert b.min() >= -0.2 and b.max() < 0.2 and abs(b.mean()) < 0.05
    assert tobs._uniform((1, 2), 0.9, 0.9) == np.float32(0.9)

    img = np.random.default_rng(3).integers(0, 256, (32, 32, 3), np.uint8)
    obs = {"image_primary": img, "image_wrist": img,
           "pad_mask_dict": {"image_primary": np.bool_(True),
                             "image_wrist": np.bool_(True)}}
    a = tobs.augment(dict(obs), (7, 9), AUG)
    again = tobs.augment(dict(obs), (7, 9), AUG)
    other = tobs.augment(dict(obs), (8, 9), AUG)
    np.testing.assert_array_equal(a["image_primary"], again["image_primary"])
    assert not np.array_equal(a["image_primary"], a["image_wrist"])
    assert not np.array_equal(a["image_primary"], other["image_primary"])
    assert a["image_primary"].dtype == np.uint8
    padded = dict(obs, pad_mask_dict={"image_primary": np.bool_(False),
                                      "image_wrist": np.bool_(True)})
    out = tobs.augment(padded, (7, 9), AUG)
    np.testing.assert_array_equal(out["image_primary"], img)


# --- the OXE factory ---------------------------------------------------------------


def _comparable(kw, registry):
    """The kwargs with the standardize function named by the registry
    entry that holds it (the JAX package aliases one function under many
    names, the port defines one per family)."""
    out = dict(kw)
    fn = out.pop("standardize_fn")
    assert fn is registry[out["name"]]
    out["standardize_fn"] = out["name"]
    out["action_proprio_normalization_type"] = str(
        out["action_proprio_normalization_type"].value)
    return out


def _configs():
    from vla_adapter_torch.data.rlds.oxe.configs import OXE_DATASET_CONFIGS

    return sorted(OXE_DATASET_CONFIGS)


@pytest.mark.parametrize("views", [("primary",), ("primary", "wrist")])
def test_make_oxe_dataset_kwargs_matches_jax(views):
    for name in _configs():
        try:
            want = jmat.make_oxe_dataset_kwargs(name, "/data",
                                                load_camera_views=views)
        except ValueError as err:
            with pytest.raises(ValueError, match=str(err).split(":")[0]):
                tmat.make_oxe_dataset_kwargs(name, "/data",
                                             load_camera_views=views)
            continue
        got = tmat.make_oxe_dataset_kwargs(name, "/data",
                                           load_camera_views=views)
        assert _comparable(got, tox.OXE_STANDARDIZATION_TRANSFORMS) == \
            _comparable(want, jox.OXE_STANDARDIZATION_TRANSFORMS), name


def test_oxe_mixtures_match_jax():
    from vla_adapter_torch.data.rlds.oxe.mixtures import OXE_NAMED_MIXTURES

    for mixture in sorted(OXE_NAMED_MIXTURES):
        try:
            jkw, jw = jmat.get_oxe_dataset_kwargs_and_weights(
                "/data", mixture, load_camera_views=("primary",))
        except ValueError:
            with pytest.raises(ValueError):
                tmat.get_oxe_dataset_kwargs_and_weights(
                    "/data", mixture, load_camera_views=("primary",))
            continue
        tkw, tw = tmat.get_oxe_dataset_kwargs_and_weights(
            "/data", mixture, load_camera_views=("primary",))
        assert tw == jw, mixture
        assert [_comparable(k, tox.OXE_STANDARDIZATION_TRANSFORMS)
                for k in tkw] == [
            _comparable(k, jox.OXE_STANDARDIZATION_TRANSFORMS) for k in jkw]
