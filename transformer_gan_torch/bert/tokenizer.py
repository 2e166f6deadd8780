"""MIDI token vocabulary of the BERT stack (the port's own copy of
``transformer_gan_tpu/bert/tokenizer.py``, counterpart of the reference
BERT/tokenization_midi.py): the 310-token performance vocab with ``[PAD]``
overriding index 1 and ``[MASK]`` appended at the end; ``encode(path)``
loads a token npy.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np


class MIDITokenizer:
    def __init__(self, vocab_file: str):
        with open(vocab_file, "r") as f:
            contents = f.read().strip().split()
        vocab = OrderedDict()
        for index, token in enumerate(contents):
            if index == 1:
                vocab["[PAD]"] = 1
            else:
                vocab[token] = index
        vocab["[MASK]"] = len(vocab)
        self.vocab = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}

    @property
    def pad_token_id(self) -> int:
        return 1

    @property
    def mask_token_id(self) -> int:
        return self.vocab["[MASK]"]

    def __len__(self) -> int:
        return len(self.vocab)

    def encode(self, input_numpy: str) -> np.ndarray:
        return np.load(input_numpy)

    def convert_tokens_to_ids(self, token: str) -> int:
        return self.vocab[token]

    def convert_ids_to_tokens(self, idx: int) -> str:
        return self.ids_to_tokens[idx]
