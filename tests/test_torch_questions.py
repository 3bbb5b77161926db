"""The port's question tokenizer (``dualvgr_tpu_torch/data/questions.py``)
against the JAX package's and nltk's.

Over a fixed list of questions (contractions, quotes, commas, hyphens,
numbers, ``...``, curly apostrophes, brackets, the synthetic fixture's
questions), the port's ``tokenize_question`` and ``encode_tokens`` give
exactly what ``preprocess/datautils/questions_common.py`` gives here (where
nltk's punkt data is missing, so it takes the Treebank tokenizer), and
``treebank_tokenize`` exactly what ``nltk.tokenize.TreebankWordTokenizer``
gives. No tolerance: the tokens are strings.
"""

import os
import pickle

import nltk
import pytest

from dualvgr_tpu_torch.data import questions as tq
from dualvgr_tpu_torch.data.vocab import load_vocab
from preprocess.datautils import questions_common as jq

QUESTIONS = [
    "what is the man doing?",
    "What's the woman's name?",
    "who can't open the door?",
    "why didn't they go, and where'd they end up?",
    "is it a 3-year-old dog or a well-known cat?",
    "how many people are there: 2, 3 or 10,000?",
    "what does \"hello\" mean in the video?",
    "what happens next... after the jump?",
    "what are the cats’ toys?",
    "who said 'go away' to the boy?",
    "what's in the (red) box [left]?",
    "cannot you see what they're gonna do?",
    "what did he say -- yes or no?",
    "what costs $3.88 at the store?",
    "is the dog's ball blue; or green?",
    "'twas the night before what?",
    "what is the U.S. flag colour?",
    "  what   is  spaced   out?",
    "who wanna dance tonight?",
    "what do they gimme?",
    "?",
    "",
]


@pytest.mark.parametrize("question", QUESTIONS)
def test_tokenize_question_matches_the_jax_package_and_nltk(question):
    assert tq.tokenize_question(question) == jq.tokenize_question(question)
    text = question.lower()[:-1]
    assert tq.treebank_tokenize(text) == nltk.tokenize.TreebankWordTokenizer().tokenize(text)
    assert tq.treebank_tokenize(question) == nltk.tokenize.TreebankWordTokenizer().tokenize(question)


def test_encode_tokens_matches_the_jax_package():
    vocab = {"<NULL>": 0, "<UNK>": 1, "what": 2, "is": 3, "the": 4, "'s": 5, "n't": 6}
    for question in QUESTIONS:
        tokens = tq.tokenize_question(question)
        assert tq.encode_tokens(tokens, vocab) == jq.encode_tokens(tokens, vocab)


def test_synthetic_questions_encode_as_the_fixture_does(synth_dir):
    """The fixture's test questions, written out from their token ids,
    encode back to the same ids through both packages."""
    vocab = load_vocab(synth_dir["vocab"])
    words, ids = vocab["question_idx_to_token"], vocab["question_token_to_idx"]
    with open(os.path.join(synth_dir["dir"], "svqa_test_questions.pt"), "rb") as f:
        obj = pickle.load(f)
    for q, n in zip(obj["questions"], obj["questions_len"]):
        text = " ".join(words[int(w)] for w in q[:n]) + "?"
        got = tq.encode_tokens(tq.tokenize_question(text), ids)
        assert got == jq.encode_tokens(jq.tokenize_question(text), ids) == [int(w) for w in q[:n]]


def test_word_tokenize_differs_on_curly_apostrophes():
    """The documented difference: nltk's word_tokenize (NLTKWordTokenizer,
    where punkt's data is installed) splits a curly apostrophe off; the
    Treebank tokenizer, and so the port, keeps it on the word."""
    text = "cats’ toys"
    assert tq.treebank_tokenize(text) == ["cats’", "toys"]
    assert nltk.tokenize.NLTKWordTokenizer().tokenize(text) == ["cats", "’", "toys"]
