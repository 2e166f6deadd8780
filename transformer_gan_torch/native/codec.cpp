// Native MIDI -> performance-token encoder.
//
// The port's copy of native/codec.cpp: the C++ counterpart of the Python
// pipeline in transformer_gan_torch/data (midi.py SMF parsing, sequences.py
// sustain/stretch/transpose/quantize, performance.py event emission).
// Bit-exact with the Python implementation: same float64 arithmetic, same
// stable orderings, same rounding (int(t*sps + 0.5)).
//
// Built at first use by transformer_gan_torch/data/native.py
// (g++ -O3 -fPIC -std=c++17 -shared) and called through its C ABI with
// ctypes.
//
// Exported:
//   tgt_encode_midi(data, len, stretch, transpose, pitch_filter,
//                   out, out_cap) -> n_tokens (<0 on error)
//   tgt_encode_midi_grid(...)    -> parse once, emit the whole
//                                   augmentation grid

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMinPitch = 21;
constexpr int kMaxPitch = 108;
constexpr int kStepsPerSecond = 100;
constexpr int kNumVelocityBins = 32;
constexpr int kMaxShiftSteps = 100;

struct Note {
  int pitch;
  int velocity;
  double start;
  double end;
  int instrument;
  int program;
  bool is_drum;
  int order;  // original position for stable ordering
};

struct CC {
  double time;
  int number;
  int value;
  int instrument;
  int program;
};

struct Parsed {
  std::vector<Note> notes;
  std::vector<CC> ccs;
  double total_time = 0.0;
  bool ok = false;
};

struct Reader {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;
  bool fail = false;

  uint32_t be32() {
    if (pos + 4 > n) { fail = true; return 0; }
    uint32_t v = (uint32_t(p[pos]) << 24) | (uint32_t(p[pos + 1]) << 16) |
                 (uint32_t(p[pos + 2]) << 8) | uint32_t(p[pos + 3]);
    pos += 4;
    return v;
  }
  uint16_t be16() {
    if (pos + 2 > n) { fail = true; return 0; }
    uint16_t v = (uint16_t(p[pos]) << 8) | uint16_t(p[pos + 1]);
    pos += 2;
    return v;
  }
  uint8_t u8() {
    if (pos >= n) { fail = true; return 0; }
    return p[pos++];
  }
  uint32_t varlen() {
    uint32_t v = 0;
    for (int i = 0; i < 4; ++i) {
      uint8_t b = u8();
      v = (v << 7) | (b & 0x7F);
      if (!(b & 0x80)) break;
    }
    return v;
  }
};

// Tempo map: tick -> seconds (piecewise over tempo changes, float64).
struct TickToTime {
  std::vector<int64_t> ticks;
  std::vector<double> times;
  std::vector<double> us_per_tick;

  void build(std::vector<std::pair<int64_t, int64_t>> changes, int ppq) {
    std::sort(changes.begin(), changes.end());
    if (changes.empty() || changes.front().first > 0)
      changes.insert(changes.begin(), {0, 500000});
    double t = 0.0;
    int64_t last_tick = 0;
    double last_uspq = double(changes.front().second);
    ticks.push_back(0);
    times.push_back(0.0);
    us_per_tick.push_back(last_uspq / ppq);
    for (size_t i = 1; i < changes.size(); ++i) {
      t += double(changes[i].first - last_tick) * (last_uspq / ppq) * 1e-6;
      last_tick = changes[i].first;
      last_uspq = double(changes[i].second);
      ticks.push_back(last_tick);
      times.push_back(t);
      us_per_tick.push_back(last_uspq / ppq);
    }
  }

  double operator()(int64_t tick) const {
    size_t lo = 0, hi = ticks.size() - 1;
    while (lo < hi) {
      size_t mid = (lo + hi + 1) / 2;
      if (ticks[mid] <= tick) lo = mid; else hi = mid - 1;
    }
    return times[lo] + double(tick - ticks[lo]) * us_per_tick[lo] * 1e-6;
  }
};

struct RawEvent {
  int64_t tick;
  uint8_t kind;  // status & 0xF0 or 0xFF
  uint8_t channel;
  uint8_t d1, d2;
};

Parsed parse_midi(const uint8_t* data, size_t len) {
  Parsed out;
  Reader r{data, len};
  if (len < 14 || memcmp(data, "MThd", 4) != 0) return out;
  r.pos = 4;
  uint32_t hdr_len = r.be32();
  r.be16();  // format
  uint16_t ntrks = r.be16();
  uint16_t division = r.be16();
  if (division & 0x8000) return out;  // SMPTE unsupported
  int ppq = division;
  r.pos = 8 + hdr_len;

  std::vector<std::vector<RawEvent>> tracks;
  std::vector<std::pair<int64_t, int64_t>> tempo_changes;

  for (int trk = 0; trk < ntrks && !r.fail; ++trk) {
    if (r.pos + 8 > r.n || memcmp(data + r.pos, "MTrk", 4) != 0) return out;
    r.pos += 4;
    uint32_t trk_len = r.be32();
    size_t trk_end = r.pos + trk_len;
    if (trk_end > r.n) return out;

    tracks.emplace_back();
    auto& events = tracks.back();
    int64_t tick = 0;
    uint8_t running = 0;
    while (r.pos < trk_end && !r.fail) {
      tick += r.varlen();
      uint8_t status = r.u8();
      if (status & 0x80) {
        if (status < 0xF0) running = status;
      } else {
        r.pos -= 1;
        status = running;
      }
      uint8_t kind = status & 0xF0;
      uint8_t channel = status & 0x0F;
      if (kind == 0x80 || kind == 0x90 || kind == 0xA0 || kind == 0xB0 ||
          kind == 0xE0) {
        uint8_t d1 = r.u8(), d2 = r.u8();
        events.push_back({tick, kind, channel, d1, d2});
      } else if (kind == 0xC0 || kind == 0xD0) {
        uint8_t d1 = r.u8();
        events.push_back({tick, kind, channel, d1, 0});
      } else if (status == 0xFF) {
        uint8_t meta = r.u8();
        uint32_t mlen = r.varlen();
        if (meta == 0x51 && mlen == 3 && r.pos + 3 <= r.n) {
          int64_t uspq = (int64_t(data[r.pos]) << 16) |
                         (int64_t(data[r.pos + 1]) << 8) |
                         int64_t(data[r.pos + 2]);
          tempo_changes.push_back({tick, uspq});
        }
        r.pos += mlen;
      } else if (status == 0xF0 || status == 0xF7) {
        uint32_t slen = r.varlen();
        r.pos += slen;
      } else {
        return out;  // unhandled status
      }
    }
    r.pos = trk_end;
  }
  if (r.fail) return out;

  TickToTime t2t;
  t2t.build(tempo_changes, ppq);

  int order = 0;
  for (size_t inst = 0; inst < tracks.size(); ++inst) {
    int program[16] = {0};
    // (channel, pitch) -> open (start_tick, velocity) FIFO
    std::vector<std::pair<int64_t, int>> open_notes[16][128];
    for (const auto& ev : tracks[inst]) {
      if (ev.kind == 0xC0) {
        program[ev.channel] = ev.d1;
      } else if (ev.kind == 0x90 && ev.d2 > 0) {
        open_notes[ev.channel][ev.d1].push_back({ev.tick, ev.d2});
      } else if (ev.kind == 0x80 || (ev.kind == 0x90 && ev.d2 == 0)) {
        auto& open = open_notes[ev.channel][ev.d1];
        std::vector<std::pair<int64_t, int>> still;
        for (const auto& on : open) {
          if (on.first == ev.tick) {  // zero-length so far stays open
            still.push_back(on);
            continue;
          }
          Note note;
          note.pitch = ev.d1;
          note.velocity = on.second;
          note.start = t2t(on.first);
          note.end = t2t(ev.tick);
          note.instrument = int(inst);
          note.program = program[ev.channel];
          note.is_drum = (ev.channel == 9);
          note.order = order++;
          out.notes.push_back(note);
          if (note.end > out.total_time) out.total_time = note.end;
        }
        open = still;
      } else if (ev.kind == 0xB0) {
        out.ccs.push_back({t2t(ev.tick), ev.d1, ev.d2, int(inst),
                           program[ev.channel]});
      }
    }
  }
  // match python: notes sorted by (instrument, start_time, pitch), stable
  std::stable_sort(out.notes.begin(), out.notes.end(),
                   [](const Note& a, const Note& b) {
                     if (a.instrument != b.instrument)
                       return a.instrument < b.instrument;
                     if (a.start != b.start) return a.start < b.start;
                     return a.pitch < b.pitch;
                   });
  std::stable_sort(out.ccs.begin(), out.ccs.end(),
                   [](const CC& a, const CC& b) {
                     if (a.instrument != b.instrument)
                       return a.instrument < b.instrument;
                     return a.time < b.time;
                   });
  out.ok = true;
  return out;
}

// sequences.py apply_sustain_control_changes, bit-identical semantics.
void apply_sustain(Parsed& ns) {
  enum { SUSTAIN_ON = 0, SUSTAIN_OFF = 1, NOTE_ON = 2, NOTE_OFF = 3 };
  struct Ev {
    double time;
    int kind;
    int idx;   // note index or cc index
    int seq;   // insertion order for stable sort
  };
  std::vector<Ev> events;
  int seq = 0;
  for (size_t i = 0; i < ns.ccs.size(); ++i)
    if (ns.ccs[i].number == 64 && ns.ccs[i].value >= 64)
      events.push_back({ns.ccs[i].time, SUSTAIN_ON, int(i), seq++});
  for (size_t i = 0; i < ns.ccs.size(); ++i)
    if (ns.ccs[i].number == 64 && ns.ccs[i].value < 64)
      events.push_back({ns.ccs[i].time, SUSTAIN_OFF, int(i), seq++});
  for (size_t i = 0; i < ns.notes.size(); ++i)
    events.push_back({ns.notes[i].start, NOTE_ON, int(i), seq++});
  for (size_t i = 0; i < ns.notes.size(); ++i)
    events.push_back({ns.notes[i].end, NOTE_OFF, int(i), seq++});
  std::stable_sort(events.begin(), events.end(),
                   [](const Ev& a, const Ev& b) {
                     if (a.time != b.time) return a.time < b.time;
                     return a.kind < b.kind;
                   });

  // keyed by (instrument, program); piano data uses few keys — linear map
  struct KeyState {
    int instrument, program;
    bool sus = false;
    std::vector<int> active;  // note indices
  };
  std::vector<KeyState> states;
  auto state_for = [&](int instrument, int program) -> KeyState& {
    for (auto& s : states)
      if (s.instrument == instrument && s.program == program) return s;
    states.push_back({instrument, program});
    return states.back();
  };

  std::vector<bool> deleted(ns.notes.size(), false);
  double time = 0.0;
  for (const auto& ev : events) {
    time = ev.time;
    if (ev.kind == SUSTAIN_ON) {
      const CC& cc = ns.ccs[ev.idx];
      state_for(cc.instrument, cc.program).sus = true;
    } else if (ev.kind == SUSTAIN_OFF) {
      const CC& cc = ns.ccs[ev.idx];
      KeyState& st = state_for(cc.instrument, cc.program);
      st.sus = false;
      std::vector<int> still;
      for (int ni : st.active) {
        if (ns.notes[ni].end < time) {
          ns.notes[ni].end = time;
          if (time > ns.total_time) ns.total_time = time;
        } else {
          still.push_back(ni);
        }
      }
      st.active = still;
    } else if (ev.kind == NOTE_ON) {
      Note& note = ns.notes[ev.idx];
      KeyState& st = state_for(note.instrument, note.program);
      if (st.sus) {
        std::vector<int> still;
        for (int ni : st.active) {
          if (ns.notes[ni].pitch == note.pitch) {
            ns.notes[ni].end = time;
            if (ns.notes[ni].start == ns.notes[ni].end) deleted[ni] = true;
          } else {
            still.push_back(ni);
          }
        }
        st.active = still;
      }
      st.active.push_back(ev.idx);
    } else {  // NOTE_OFF
      Note& note = ns.notes[ev.idx];
      KeyState& st = state_for(note.instrument, note.program);
      if (!st.sus) {
        auto it = std::find(st.active.begin(), st.active.end(), ev.idx);
        if (it != st.active.end()) st.active.erase(it);
      }
    }
  }
  for (auto& st : states)
    for (int ni : st.active) {
      ns.notes[ni].end = time;
      ns.total_time = time;
    }

  if (std::any_of(deleted.begin(), deleted.end(), [](bool b) { return b; })) {
    std::vector<Note> kept;
    for (size_t i = 0; i < ns.notes.size(); ++i)
      if (!deleted[i]) kept.push_back(ns.notes[i]);
    ns.notes = kept;
  }
}

inline int64_t quantize_to_step(double seconds) {
  return int64_t(seconds * kStepsPerSecond + 0.5);
}

inline int velocity_bin_size() {
  return int(std::ceil((127.0 - 1.0 + 1.0) / kNumVelocityBins));
}

// Token id layout (data/performance_vocab.txt): 0 <S>, 1 <PAD>,
// 2..101 TIME_SHIFT_1..100, then interleaved NOTE_ON/NOTE_OFF for
// pitch 21..108, then VELOCITY_1..32.
inline int id_time_shift(int v) { return 2 + (v - 1); }
inline int id_note_on(int pitch) { return 102 + 2 * (pitch - kMinPitch); }
inline int id_note_off(int pitch) { return 103 + 2 * (pitch - kMinPitch); }
inline int id_velocity(int bin) { return 102 + 2 * 88 + (bin - 1); }

// sequences.py stretch/transpose + quantize + performance.py event stream.
int encode_tokens(const Parsed& parsed, double stretch, int transpose,
                  bool pitch_filter, int32_t* out, size_t out_cap) {
  struct QNote {
    int64_t start_step, end_step;
    double start;
    int pitch, velocity;
  };
  std::vector<QNote> notes;
  notes.reserve(parsed.notes.size());
  for (const Note& n : parsed.notes) {
    if (n.is_drum) continue;
    int pitch = n.pitch;
    if (transpose != 0 || !pitch_filter) {
      // augmentation path: transpose + range enforcement
      pitch += transpose;
      if (pitch < kMinPitch || pitch > kMaxPitch) continue;
    } else if (pitch_filter && (pitch < kMinPitch || pitch > kMaxPitch)) {
      continue;
    }
    double start = n.start * stretch;
    double end = n.end * stretch;
    int64_t qs = quantize_to_step(start);
    int64_t qe = quantize_to_step(end);
    if (qe == qs) qe += 1;
    notes.push_back({qs, qe, start, pitch, n.velocity});
  }
  // performance.py: sort by (start_time, pitch), stable
  std::stable_sort(notes.begin(), notes.end(),
                   [](const QNote& a, const QNote& b) {
                     if (a.start != b.start) return a.start < b.start;
                     return a.pitch < b.pitch;
                   });

  struct NoteEvent {
    int64_t step;
    int idx;
    bool is_offset;
  };
  std::vector<NoteEvent> evs;
  evs.reserve(notes.size() * 2);
  for (size_t i = 0; i < notes.size(); ++i)
    evs.push_back({notes[i].start_step, int(i), false});
  for (size_t i = 0; i < notes.size(); ++i)
    evs.push_back({notes[i].end_step, int(i), true});
  std::sort(evs.begin(), evs.end(), [](const NoteEvent& a,
                                       const NoteEvent& b) {
    if (a.step != b.step) return a.step < b.step;
    if (a.idx != b.idx) return a.idx < b.idx;
    return int(a.is_offset) < int(b.is_offset);
  });

  size_t n_out = 0;
  auto emit = [&](int id) -> bool {
    if (n_out >= out_cap) return false;
    out[n_out++] = id;
    return true;
  };

  int64_t current_step = 0;
  int current_velocity_bin = 0;
  int vbin_size = velocity_bin_size();
  for (const auto& ev : evs) {
    if (ev.step > current_step) {
      while (ev.step > current_step + kMaxShiftSteps) {
        if (!emit(id_time_shift(kMaxShiftSteps))) return -2;
        current_step += kMaxShiftSteps;
      }
      if (!emit(id_time_shift(int(ev.step - current_step)))) return -2;
      current_step = ev.step;
    }
    int velocity_bin = (notes[ev.idx].velocity - 1) / vbin_size + 1;
    if (!ev.is_offset && velocity_bin != current_velocity_bin) {
      current_velocity_bin = velocity_bin;
      if (!emit(id_velocity(velocity_bin))) return -2;
    }
    if (!emit(ev.is_offset ? id_note_off(notes[ev.idx].pitch)
                           : id_note_on(notes[ev.idx].pitch)))
      return -2;
  }
  return int(n_out);
}

}  // namespace

extern "C" {

// Encode one MIDI with optional stretch/transpose.
// pitch_filter: 1 = canonical encode() path (filter to [21,108] without
// transposition semantics), 0 = augmentation path (transpose handles range).
// Returns token count, or -1 (parse error) / -2 (out_cap too small).
int tgt_encode_midi(const uint8_t* data, size_t len, double stretch,
                    int transpose, int pitch_filter, int32_t* out,
                    size_t out_cap) {
  Parsed parsed = parse_midi(data, len);
  if (!parsed.ok) return -1;
  apply_sustain(parsed);
  return encode_tokens(parsed, stretch, transpose, pitch_filter != 0, out,
                       out_cap);
}

// Parse once, emit the whole (stretch x transpose) augmentation grid.
// lengths[i] receives each encoding's token count; encodings are packed
// back-to-back in out. Returns number of encodings, or <0 on error.
int tgt_encode_midi_grid(const uint8_t* data, size_t len,
                         const double* stretches, int n_stretches,
                         int transpose_lo, int transpose_hi, int32_t* out,
                         size_t out_cap, int32_t* lengths) {
  Parsed parsed = parse_midi(data, len);
  if (!parsed.ok) return -1;
  apply_sustain(parsed);
  int count = 0;
  size_t used = 0;
  for (int si = 0; si < n_stretches; ++si) {
    for (int tr = transpose_lo; tr <= transpose_hi; ++tr) {
      int n = encode_tokens(parsed, stretches[si], tr, false, out + used,
                            out_cap - used);
      if (n < 0) return n;
      lengths[count++] = n;
      used += size_t(n);
    }
  }
  return count;
}

}  // extern "C"
