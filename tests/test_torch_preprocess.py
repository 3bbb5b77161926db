"""The port's preprocessing (``dualvgr_tpu_torch.preprocess``) against the
JAX package's (``preprocess/``), on the CPU.

* The clip sampler on tiny mp4s written with cv2 (as
  ``tests/test_preprocess.py`` writes them): the port's clips bit for bit
  the JAX sampler's at the identity size (no resize), both layouts, for
  videos shorter and longer than a clip; a path that yields no frames gives
  zeros and False; a hidden cv2 raises ImportError instead.
* The resize against PIL 12's ``Image.resize(..., BICUBIC)``: at most 1
  level of difference on at most 1% of the pixels (measured: bit for bit,
  0 levels on 0 pixels, on every case here).
* The questions CLI: the vocab json and question pickles of
  ``python -m dualvgr_tpu_torch.preprocess.questions`` equal
  ``preprocess/preprocess_questions.py``'s on the SVQA fixture of
  ``tests/test_preprocess.py``.
* ``generate_h5`` at reduced depth and size: the JAX schema, the ids in
  the shuffled order of the JAX CLI, zero rows for broken videos, and
  each row the extractor's features of that video's clips.
"""

import json
import pickle
import sys
import types

import h5py
import numpy as np
import pytest
import torch
from PIL import Image

from preprocess import preprocess_questions as jax_questions
from preprocess.preprocess_features import extract_clips_with_consecutive_frames as jax_extract
from dualvgr_tpu_torch.preprocess import features, questions
from dualvgr_tpu_torch.preprocess.resize import resize_bicubic


def write_video(path, n_frames, size=(32, 24), seed=0):
    import cv2

    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10.0, size)
    if not w.isOpened():
        pytest.skip("no mp4 encoder available")
    rng = np.random.RandomState(seed)
    for i in range(n_frames):
        frame = rng.randint(0, 255, (size[1], size[0], 3), np.uint8)
        frame[:, :, 0] = i * 5  # the frame index in blue, as tests/test_preprocess.py writes it
        w.write(frame)
    w.release()


@pytest.mark.parametrize("motion_layout", [False, True])
@pytest.mark.parametrize("n_frames,num_clips", [(1, 2), (9, 3), (20, 2), (40, 4)])
def test_the_sampler_is_the_jax_samplers_at_the_identity_size(tmp_path, n_frames, num_clips, motion_layout):
    path = str(tmp_path / "v.mp4")
    write_video(path, n_frames)
    size = (32, 24)  # PIL's (width, height): the frames' own size, so no resize
    want, ok_j = jax_extract(path, num_clips, 16, size, motion_layout)
    got, ok = features.extract_clips_with_consecutive_frames(path, num_clips, 16, size, motion_layout, device="cpu")
    assert ok and ok_j
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("total", [1, 2, 7, 8, 9, 15, 16, 17, 33, 100])
@pytest.mark.parametrize("num_clips", [1, 3, 16])
def test_sample_clip_indices_stay_in_range_and_consecutive(total, num_clips):
    idx = features.sample_clip_indices(total, num_clips, 16)
    assert idx.shape == (num_clips, 16) and idx.min() >= 0 and idx.max() < total
    assert (np.diff(idx, axis=1) >= 0).all() and (np.diff(idx, axis=1) <= 1).all()


def test_a_broken_video_gives_zeros_and_false(tmp_path):
    for path in ("/nonexistent/file.mp4", str(tmp_path / "empty.mp4")):
        open(tmp_path / "empty.mp4", "wb").close()
        clips, valid = features.extract_clips_with_consecutive_frames(path, 2, 16, (24, 24), False, device="cpu")
        assert not valid and clips.shape == (2, 16, 3, 24, 24) and (clips == 0).all()
        clips, valid = features.extract_clips_with_consecutive_frames(path, 2, 16, (24, 24), True, device="cpu")
        assert not valid and clips.shape == (2, 3, 16, 24, 24)


def test_a_hidden_cv2_raises_instead_of_writing_zero_features(tmp_path, monkeypatch):
    path = str(tmp_path / "v.mp4")
    write_video(path, 5)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        features.extract_clips_with_consecutive_frames(path, 2, 16, (24, 24), False, device="cpu")


RESIZE_CASES = [((240, 320), (224, 224)), ((240, 320), (112, 112)), ((24, 32), (48, 48)),
                ((100, 57), (224, 224)), ((7, 9), (3, 5)), ((240, 320), (240, 100)), ((33, 47), (200, 13))]


@pytest.mark.parametrize("src,dst", RESIZE_CASES)
def test_the_resize_is_pils_bicubic(src, dst):
    rng = np.random.RandomState(sum(src) + sum(dst))
    noise = rng.randint(0, 256, (*src, 3), dtype=np.uint8)
    smooth = (np.cumsum(rng.randint(0, 4, (*src, 3)), axis=1) % 256).astype(np.uint8)
    diffs = []
    for img in (noise, smooth):
        want = np.asarray(Image.fromarray(img).resize((dst[1], dst[0]), Image.BICUBIC))
        got = resize_bicubic(torch.from_numpy(img).permute(2, 0, 1), dst).permute(1, 2, 0).numpy()
        assert got.dtype == np.uint8 and got.shape == want.shape
        diffs.append(np.abs(got.astype(int) - want.astype(int)))
    d = np.concatenate([x.ravel() for x in diffs])
    assert d.max() <= 1 and (d > 0).mean() <= 0.01, (d.max(), (d > 0).mean())


def test_clips_from_frames_resizes_each_sampled_frame_as_pil_does():
    rng = np.random.RandomState(3)
    frames = rng.randint(0, 256, (20, 30, 40, 3), dtype=np.uint8)
    clips = features.clips_from_frames(frames, 2, 16, (24, 18), False, device="cpu")
    idx = features.sample_clip_indices(20, 2, 16)
    assert clips.shape == (2, 16, 3, 18, 24) and clips.dtype == torch.float32
    for c in range(2):
        for f in (0, 7, 15):
            want = np.asarray(Image.fromarray(frames[idx[c, f]]).resize((24, 18), Image.BICUBIC))
            np.testing.assert_array_equal(clips[c, f].permute(1, 2, 0).numpy(), want.astype(np.float32))
    motion = features.clips_from_frames(frames, 2, 16, (24, 18), True, device="cpu")
    assert torch.equal(motion, clips.transpose(1, 2))


@pytest.fixture
def svqa_annotations(tmp_path):
    """The SVQA fixture of tests/test_preprocess.py."""
    qs = [
        ("what color is the ball?", "red", "query_color", 0),
        ("is there a cube?", "yes", "exist", 0),
        ("how many spheres are there?", "3", "count", 1),
        ("what color is the cube?", "blue", "query_color", 1),
        ("is there a cylinder moving?", "rareanswer", "exist", 2),
    ]
    insts = [{"question": q, "ans": a, "id": vid, "program": [{"function": cat}]} for q, a, cat, vid in qs]
    (tmp_path / "train_qa.json").write_text(json.dumps(insts))
    val = [{"question": "what color is the mat?", "ans": "neverseen", "id": 0,
            "program": [{"function": "query_color"}]}]
    (tmp_path / "val_qa.json").write_text(json.dumps(val))
    glove = {"the": np.ones(8, np.float32), "what": np.full(8, 2.0, np.float32),
             "color": np.full(8, 3.0, np.float32)}
    with open(tmp_path / "glove.pkl", "wb") as f:
        pickle.dump(glove, f)
    return tmp_path


def _questions_cli(main, d, out, mode):
    main(["--dataset", "svqa", "--mode", mode, "--annotation_file", str(d / "{mode}_qa.json"),
          "--glove_pt", str(d / "glove.pkl"), "--output_pt", str(out / "{}_{}_{}_questions.pt"),
          "--vocab_json", str(out / "{}_{}_vocab.json"), "--answer_top", "3"])


def test_the_questions_cli_writes_the_jax_clis_files(svqa_annotations):
    d = svqa_annotations
    (d / "port").mkdir()
    (d / "jax").mkdir()
    for mode in ("train", "val"):
        _questions_cli(questions.main, d, d / "port", mode)
        _questions_cli(jax_questions.main, d, d / "jax", mode)
        with open(d / "port" / f"svqa_svqa_{mode}_questions.pt", "rb") as fp, \
                open(d / "jax" / f"svqa_svqa_{mode}_questions.pt", "rb") as fj:
            p, j = pickle.load(fp), pickle.load(fj)
        assert sorted(p) == sorted(j)
        for k in j:
            if j[k] is None:
                assert p[k] is None, k
            elif isinstance(j[k], np.ndarray):
                assert p[k].dtype == j[k].dtype, k
                np.testing.assert_array_equal(p[k], j[k])
            else:
                assert p[k] == j[k], k
    assert (d / "port" / "svqa_svqa_vocab.json").read_text() == (d / "jax" / "svqa_svqa_vocab.json").read_text()


def test_generate_h5_writes_the_jax_schema(tmp_path):
    import random

    from dualvgr_tpu_torch.preprocess.datautils import svqa

    vdir = tmp_path / "videos"
    vdir.mkdir()
    write_video(vdir / "0.mp4", 24, seed=1)
    write_video(vdir / "1.mp4", 9, seed=2)  # video 2 is missing: a broken video
    insts = [{"question": "what is it?", "ans": "x", "id": v, "program": [{"function": "exist"}]}
             for v in (0, 1, 2, 1)]
    (tmp_path / "train_qa.json").write_text(json.dumps(insts))
    args = types.SimpleNamespace(annotation_file=str(tmp_path / "train_qa.json"), video_dir=str(vdir) + "/",
                                 num_clips=2, image_height=40, image_width=40, videos_per_batch=2,
                                 decode_threads=2, device="cpu", ckpt="", compute_dtype="float32")
    paths = svqa.load_video_paths(args)
    random.seed(666)
    random.shuffle(paths)  # as main() shuffles them
    for kind in ("appearance", "motion"):
        build = features.build_appearance_extractor if kind == "appearance" else features.build_motion_extractor
        extractor = build(device="cpu", layers=(1, 1, 1, 1))
        args.feature_type = kind
        args.outfile = str(tmp_path / f"svqa_{kind}_feat.h5")
        features.generate_h5(args, paths, extractor=extractor)
        name = "resnet_features" if kind == "appearance" else "resnext_features"
        with h5py.File(args.outfile) as f:
            assert sorted(f) == ["ids", name]
            feats, ids = f[name][()], f["ids"][()]
        assert feats.dtype == np.float32 and ids.dtype == np.int64
        assert feats.shape == ((3, 2, 16, 2048) if kind == "appearance" else (3, 2, 2048))
        assert ids.tolist() == [v for _, v in paths]
        for row, (path, vid) in enumerate(paths):
            if vid == 2:
                assert (feats[row] == 0).all()
                continue
            clips, ok = features.extract_clips_with_consecutive_frames(path, 2, 16, (40, 40), kind == "motion",
                                                                      device="cpu")
            x = torch.from_numpy(clips)
            want = extractor(x.reshape(-1, *x.shape[2:]) if kind == "appearance" else x).reshape(feats[row].shape)
            assert ok and np.abs(feats[row] - want.numpy()).max() <= 1e-4 * np.abs(want.numpy()).max()


def test_the_features_cli_runs_on_cuda_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    (tmp_path / "qa.json").write_text("[]")
    with pytest.raises(RuntimeError, match="cuda"):
        features.main(["--annotation_file", str(tmp_path / "qa.json"), "--video_dir", str(tmp_path)])


def test_the_features_cli_writes_the_schema_in_the_seeded_order(tmp_path):
    import random

    from dualvgr_tpu_torch.preprocess.datautils import svqa

    vdir = tmp_path / "videos"
    vdir.mkdir()
    for vid in (3, 5, 8):
        write_video(vdir / f"{vid}.mp4", 12, seed=vid)
    insts = [{"question": "is it?", "ans": "yes", "id": v, "program": [{"function": "exist"}]} for v in (3, 5, 8, 9)]
    (tmp_path / "qa.json").write_text(json.dumps(insts))
    out = tmp_path / "app.h5"
    features.main(["--dataset", "svqa", "--model", "resnet101", "--annotation_file", str(tmp_path / "qa.json"),
                   "--video_dir", str(vdir) + "/", "--outfile", str(out), "--num_clips", "2", "--image_height", "32",
                   "--image_width", "32", "--videos_per_batch", "3", "--decode_threads", "2", "--device", "cpu"])
    paths = svqa.load_video_paths(types.SimpleNamespace(annotation_file=str(tmp_path / "qa.json"),
                                                        video_dir=str(vdir) + "/"))
    random.seed(666)
    random.shuffle(paths)  # the JAX CLI's order for its default seed
    with h5py.File(out) as f:
        feats, ids = f["resnet_features"][()], f["ids"][()]
    assert feats.shape == (4, 2, 16, 2048) and ids.tolist() == [v for _, v in paths]
    for row, vid in enumerate(ids):
        assert ((feats[row] == 0).all()) == (vid == 9)  # video 9 has no file
