"""The port's rule-based letter-to-sound and CMU-dictionary functions
(a3t_tpu_torch/text/g2p.py, text/lexicon.py) equal the JAX package's
(a3t_tpu/text/g2p.py, lexicon.py) exactly: the same phones for the same
words, the same dictionaries read, the same files written."""

import numpy as np
import pytest

from a3t_tpu.text import g2p as jax_g2p
from a3t_tpu.text import lexicon as jax_lexicon
from a3t_tpu_torch.text import g2p, lexicon

WORDS = ["speech", "editing", "Hello", "world", "through", "queue", "boy",
         "Phone", "chocolate", "x-ray", "night", "", "42", "rhythm", "cake",
         "oi", "thoughtful", "shrimp", "whale", "y"]

CMU = """;;; # a comment line
HELLO  HH AH0 L OW1
HELLO(2)  HH EH0 L OW1
WORLD  W ER1 L D
speech  S P IY1 CH
BAD
ZEBRA  Z IY1 B R AH0
"""


@pytest.mark.parametrize("word", WORDS)
def test_letter_to_sound_equals_jax(word):
    assert g2p.letter_to_sound(word) == jax_g2p.letter_to_sound(word)


def test_letter_to_sound_equals_jax_on_random_words():
    rng = np.random.default_rng(0)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz'-"))
    for _ in range(1000):
        word = "".join(rng.choice(letters, rng.integers(1, 12)))
        assert g2p.letter_to_sound(word) == jax_g2p.letter_to_sound(word)


@pytest.mark.parametrize("keep_alternates", [False, True])
@pytest.mark.parametrize("strip_stress", [False, True])
def test_load_cmu_dict_equals_jax(tmp_path, keep_alternates, strip_stress):
    path = tmp_path / "dict"
    path.write_text(CMU, encoding="latin-1")
    got = lexicon.load_cmu_dict(str(path), keep_alternates, strip_stress)
    assert got == jax_lexicon.load_cmu_dict(str(path), keep_alternates,
                                            strip_stress)
    assert ("HELLO(2)" in got) == keep_alternates


def test_save_cmu_dict_and_build_lexicon_equal_jax(tmp_path):
    base = {"HELLO": ["HH", "AH0", "L", "OW1"], "WORLD": ["W", "ER1", "L",
                                                         "D"]}
    words = ["hello", "Hello", "world", "editing", "chocolate"]
    got = lexicon.build_lexicon(words, g2p.letter_to_sound, base)
    want = jax_lexicon.build_lexicon(words, jax_g2p.letter_to_sound, base)
    assert got == want and sorted(got) == ["CHOCOLATE", "EDITING", "HELLO",
                                           "WORLD"]
    lexicon.save_cmu_dict(got, str(tmp_path / "port"))
    jax_lexicon.save_cmu_dict(want, str(tmp_path / "jax"))
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()
    assert lexicon.load_cmu_dict(str(tmp_path / "port")) == got
