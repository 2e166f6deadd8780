"""Token vocabulary and held-note status tracking (copy of
``transformer_gan_tpu/data/vocab.py``): <S> at id 0, <PAD> at id 1;
``notes_mapping`` builds the NOTE_ON / NOTE_OFF slot tables and
``update_status_vec`` advances the held-note bit-vectors of the
note-status inputs (``TRAIN.append_note_status``).
"""

from __future__ import annotations

import numpy as np


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
        self.note_on_dic: dict[int, int] = {}
        self.note_off_dic: dict[int, int] = {}

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

    def notes_mapping(self) -> None:
        """NOTE_ON / NOTE_OFF token -> status-slot maps, in vocab order
        (``vec_len`` slots), and their dense lookup tables."""
        note_on_tokens = [t for t in self._map if "NOTE_ON" in t]
        note_off_tokens = [t for t in self._map if "NOTE_OFF" in t]
        self.vec_len = len(note_on_tokens)
        self.note_on_dic, self.note_off_dic = {}, {}
        for index, (note_on, note_off) in enumerate(
                zip(note_on_tokens, note_off_tokens)):
            self.note_on_dic[self._map[note_on]] = index
            self.note_off_dic[self._map[note_off]] = index
        # token id -> slot (or -1), token id -> +1 (on) / -1 (off) / 0
        n = len(self._all_tokens)
        self._status_slot = np.full((n,), -1, dtype=np.int32)
        self._status_delta = np.zeros((n,), dtype=np.int8)
        for tok, slot in self.note_on_dic.items():
            self._status_slot[tok] = slot
            self._status_delta[tok] = 1
        for tok, slot in self.note_off_dic.items():
            self._status_slot[tok] = slot
            self._status_delta[tok] = -1

    def update_status_vec(self, data: np.ndarray,
                          status_vec: np.ndarray) -> None:
        """Advance the held-note bit-vectors [bptt, bsz, vec_len] through a
        [bptt, bsz] window in place: the state starts from
        ``status_vec[-1]`` and row t holds it after token t."""
        bptt, bsz = data.shape
        state = status_vec[-1].copy()
        slots = self._status_slot[data]
        deltas = self._status_delta[data]
        rows = np.arange(bsz)
        for t in range(bptt):
            active = deltas[t] != 0
            if active.any():
                s = slots[t]
                on = active & (deltas[t] > 0)
                off = active & (deltas[t] < 0)
                state[rows[on], s[on]] = True
                state[rows[off], s[off]] = False
            status_vec[t] = state
