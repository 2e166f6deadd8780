"""Token vocabulary (copy of ``transformer_gan_tpu/data/vocab.py`` without
the note-status tables, which the port does not read yet): <S> at id 0,
<PAD> at id 1.
"""

from __future__ import annotations


class BaseVocab:
    def __init__(self, all_tokens):
        self._all_tokens = list(all_tokens)
        self._map = {}
        self._reverse_map = {}
        for i, token in enumerate(self._all_tokens):
            self._map[token] = i
            self._reverse_map[i] = token
        if self._all_tokens[:2] != ["<S>", "<PAD>"]:
            raise ValueError("the vocab must start with <S> and <PAD>")
        self.vec_len = 0

    @classmethod
    def from_file(cls, vocab_path: str) -> "BaseVocab":
        tokens = []
        with open(vocab_path, "r") as f:
            for token in f:
                token = token.strip()
                if token:
                    tokens.append(token)
        return cls(tokens)

    def idx_to_token(self, idx):
        return self._all_tokens[idx]

    @property
    def bos_token(self):
        return self._all_tokens[0]

    @property
    def pad_token(self):
        return self._all_tokens[1]

    @property
    def bos_id(self):
        return 0

    @property
    def pad_id(self):
        return 1

    @property
    def all_tokens(self):
        return self._all_tokens

    def token_to_idx(self, token):
        return self._map[token]

    def __len__(self):
        return len(self._all_tokens)

    def __getitem__(self, token):
        return self._map[token]
