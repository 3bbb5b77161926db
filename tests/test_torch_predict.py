"""The slice as a whole: raw video + question -> answer, the port against the
JAX package, on the CPU.

The same tiny mp4 (written with cv2) and questions go through

* the JAX pipeline composed from its functions: its clip sampler
  (``preprocess/preprocess_features.py``), flax ``ResNet101`` and
  ``ResNeXt101_3D`` at ``layers=(1, 1, 1, 1)`` with its extractors'
  normalisation, the nltk-free question encoding of ``predict.py``, and a
  flax ``DualVGR`` at small dims (``apply(train=False)``);
* the port's ``predict.predict_frames`` (decoded once, resized in torch,
  both backbones, one DualVGR forward), every weight carried across
  (``resnet101_from_flax``, ``resnext101_from_flax``,
  ``from_jax_variables``).

Logits agree within 1e-4 x max|logit| with the same top-1. Then ``python
-m dualvgr_tpu_torch.predict ... --device cpu`` runs end to end from a
port checkpoint and prints the top-k; without ``--device`` it raises on a
machine without CUDA.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dualvgr_tpu.models import DualVGR as JaxDualVGR
from dualvgr_tpu.models.backbones import resnet2d as jax_r2d
from dualvgr_tpu.models.backbones import resnext3d as jax_x3d
from preprocess.datautils.questions_common import encode_tokens as jax_encode
from preprocess.datautils.questions_common import tokenize_question as jax_tokenize
from preprocess.preprocess_features import extract_clips_with_consecutive_frames as jax_extract
from dualvgr_tpu_torch import build_model, create_train_state, make_optimizer
from dualvgr_tpu_torch import predict
from dualvgr_tpu_torch.data.synthetic import generate
from dualvgr_tpu_torch.preprocess.features import (
    build_appearance_extractor, build_motion_extractor, decode_video_rgb,
)
from dualvgr_tpu_torch.utils.checkpoint import save_checkpoint
from dualvgr_tpu_torch.utils.weights import from_jax_variables, resnet101_from_flax, resnext101_from_flax

from test_torch_backbones import seeded_variables
from test_torch_model import random_variables
from test_torch_preprocess import write_video

LAYERS, CLIPS, SIZE = (1, 1, 1, 1), 2, 48
WORDS = ["what", "color", "is", "the", "ball", "how", "many", "cubes", "there"]
VOCAB = {"question_token_to_idx": {"<NULL>": 0, "<UNK>": 1, **{w: i + 2 for i, w in enumerate(WORDS)}},
         "answer_idx_to_token": {i: f"ans{i}" for i in range(7)}}
QUESTIONS = ["what color is the ball?", "how many cubes are there", "is there a ball?"]
DIMS = dict(vision_dim=2048, module_dim=16, word_dim=8, question_vocab_size=len(VOCAB["question_token_to_idx"]),
            num_answers=7, num_of_nodes=CLIPS, graph_layers=1, unit_layers=1)


def jax_logits(path, questions, v_app, v_mot, v_model):
    app_m, mot_m = jax_r2d.ResNet101(layers=LAYERS), jax_x3d.ResNeXt101_3D(layers=LAYERS)
    clips_a, ok_a = jax_extract(path, CLIPS, 16, (SIZE, SIZE), motion_layout=False)
    clips_m, ok_m = jax_extract(path, CLIPS, 16, (SIZE, SIZE), motion_layout=True)
    assert ok_a and ok_m
    x = clips_a.reshape(CLIPS * 16, 3, SIZE, SIZE).transpose(0, 2, 3, 1)
    x = (x / 255.0 - jax_r2d.IMAGENET_MEAN) / jax_r2d.IMAGENET_STD_REF
    app = np.asarray(app_m.apply(v_app, jnp.asarray(x, jnp.float32))).reshape(CLIPS, 16, 2048)
    mot = np.asarray(mot_m.apply(v_mot, jnp.asarray(clips_m.transpose(0, 2, 3, 4, 1))))
    enc = [jax_encode(jax_tokenize(q if q.endswith("?") else q + "?"), VOCAB["question_token_to_idx"])
           for q in questions]
    qlen = np.asarray([len(e) for e in enc], np.int32)
    q = np.zeros((len(enc), qlen.max()), np.int32)
    for i, e in enumerate(enc):
        q[i, : len(e)] = e
    n = len(questions)
    feats = (np.repeat(app[None], n, 0), np.repeat(mot[None], n, 0))
    model = JaxDualVGR(**DIMS)
    return np.asarray(model.apply(v_model, *feats, q, qlen, train=False).logits), (*feats, q, qlen)


def test_predict_matches_the_jax_pipeline(tmp_path):
    path = str(tmp_path / "clip.mp4")
    write_video(path, 20, size=(32, 32), seed=5)
    v_app = seeded_variables(jax_r2d.ResNet101(layers=LAYERS), np.zeros((1, SIZE, SIZE, 3), np.float32), 3)
    v_mot = seeded_variables(jax_x3d.ResNeXt101_3D(layers=LAYERS), np.zeros((1, 16, SIZE, SIZE, 3), np.float32), 4)
    example = (np.zeros((1, CLIPS, 16, 2048), np.float32), np.zeros((1, CLIPS, 2048), np.float32),
               np.ones((1, 4), np.int32), np.full((1,), 4, np.int32))
    v_model = random_variables(JaxDualVGR(**DIMS), example, seed=2)
    want, _ = jax_logits(path, QUESTIONS, v_app, v_mot, v_model)

    app_x = build_appearance_extractor(device="cpu", layers=LAYERS)
    app_x.model.load_state_dict(resnet101_from_flax(v_app), strict=True)
    mot_x = build_motion_extractor(device="cpu", layers=LAYERS)
    mot_x.model.load_state_dict(resnext101_from_flax(v_mot), strict=True)
    model = build_model(device="cpu", **DIMS)
    model.load_state_dict(from_jax_variables(v_model), strict=True)
    model.eval()
    frames = decode_video_rgb(path)
    got = predict.predict_frames([frames] * len(QUESTIONS), QUESTIONS, model=model, vocab=VOCAB,
                                 app_extract=app_x, mot_extract=mot_x, num_clips=CLIPS, appearance_size=SIZE,
                                 motion_size=SIZE, device="cpu").numpy()
    assert got.shape == want.shape == (len(QUESTIONS), 7)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), np.abs(got - want).max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    ranked = predict.top_answers(got, VOCAB["answer_idx_to_token"], 3)
    assert [r[0][0] for r in ranked] == [f"ans{i}" for i in want.argmax(-1)]
    assert all(abs(sum(p for _, p in r) - 1) < 1 for r in ranked)


@pytest.fixture(scope="module")
def predict_env(tmp_path_factory):
    """A backbone-shaped synthetic dataset (vision 2048, 16 frames, 2
    clips), a port checkpoint of a seeded model and a tiny mp4."""
    out = str(tmp_path_factory.mktemp("predict"))
    paths = generate(out, dataset="svqa", num_videos=8, questions_per_video=1, num_clips=CLIPS, vision_dim=2048,
                     frames=16, num_answers=10, vocab_size=30, max_q_len=8, word_dim=16, module_dim=32,
                     batch_size=8, max_epochs=1)
    model = build_model(device="cpu", seed=1, vision_dim=2048, module_dim=32, word_dim=16, question_vocab_size=30,
                        num_answers=10, num_of_nodes=CLIPS, graph_layers=1, unit_layers=1, graph_module="GAT")
    state = create_train_state(model, make_optimizer(1e-4, 1), seed=1)
    save_checkpoint(os.path.join(out, "results", "expSynth-svqa", "ckpt"), 0, state,
                    dict(vision_dim=2048, module_dim=32, word_dim=16, num_of_nodes=CLIPS, graph_module="GAT",
                         graph_layers=1, unit_layers=1))
    video = os.path.join(out, "clip.mp4")
    write_video(video, 20, size=(32, 32), seed=6)
    return {"config": paths["config"], "video": video}


def test_the_predict_cli_runs_end_to_end_on_the_cpu(predict_env, capsys):
    logits = predict.main(["--cfg", predict_env["config"], "--video", predict_env["video"], "--question",
                           "what color is the ball", "how many cubes", "--appearance_size", "48",
                           "--motion_size", "48", "--topk", "3", "--device", "cpu"])
    assert logits.shape == (2, 10) and np.isfinite(logits).all()
    assert not np.allclose(logits[0], logits[1])  # one video, two questions
    out = capsys.readouterr().out
    assert out.count("Q: ") == 2 and "Q: what color is the ball" in out
    assert out.count("  1. ") == 2 and out.count("  3. ") == 2 and "(p=" in out


def test_the_predict_cli_runs_on_cuda_unless_told_otherwise(predict_env):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        predict.main(["--cfg", predict_env["config"], "--video", predict_env["video"], "--question", "what"])
