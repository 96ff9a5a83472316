"""Minimal pure-Python Standard MIDI File reader + note extraction (the
port's copy of ``timbre_trap_tpu/data/io/midi.py``).

The reference uses mido for MAESTRO/TRIOS note parsing with sustain-pedal
(CC64) offset extension (``datasets/SoloMultiPitch/MAESTRO.py:98-201``).
mido is not available here, so this module implements the needed subset of
SMF parsing from the spec: header/track chunks, variable-length deltas,
running status, tempo map (meta 0x51), note on/off and control-change
events, with multi-track merge and tick->seconds conversion.
"""

import numpy as np

__all__ = ["parse_midi_messages", "load_notes_midi"]

_DEFAULT_TEMPO = 500000  # microseconds per quarter note


def _read_varlen(data, pos):
    value = 0
    while True:
        byte = data[pos]
        pos += 1
        value = (value << 7) | (byte & 0x7F)
        if not byte & 0x80:
            return value, pos


def _parse_track(data):
    """Yield (tick, kind, payload) events from one MTrk chunk body."""
    events = []
    pos, tick, status = 0, 0, None
    while pos < len(data):
        delta, pos = _read_varlen(data, pos)
        tick += delta
        byte = data[pos]
        if byte == 0xFF:  # meta event
            meta_type = data[pos + 1]
            length, npos = _read_varlen(data, pos + 2)
            payload = data[npos:npos + length]
            pos = npos + length
            if meta_type == 0x51 and length == 3:
                tempo = (payload[0] << 16) | (payload[1] << 8) | payload[2]
                events.append((tick, "set_tempo", tempo))
            status = None
        elif byte in (0xF0, 0xF7):  # sysex
            length, npos = _read_varlen(data, pos + 1)
            pos = npos + length
            status = None
        else:
            if byte & 0x80:
                status = byte
                pos += 1
            elif status is None:
                raise ValueError("running status without prior status byte")
            kind = status & 0xF0
            channel = status & 0x0F
            if kind in (0x80, 0x90, 0xA0, 0xB0, 0xE0):
                d1, d2 = data[pos], data[pos + 1]
                pos += 2
                if kind == 0x90:
                    events.append((tick, "note_on" if d2 > 0 else "note_off",
                                   (channel, d1, d2)))
                elif kind == 0x80:
                    events.append((tick, "note_off", (channel, d1, d2)))
                elif kind == 0xB0:
                    events.append((tick, "control_change", (channel, d1, d2)))
            elif kind in (0xC0, 0xD0):
                pos += 1
            else:
                raise ValueError(f"unexpected status byte 0x{status:02x}")
    return events


def parse_midi_messages(path):
    """Parse an SMF file into a time-ordered list of message dicts.

    Each dict has ``time`` (absolute seconds), ``type`` and type-specific
    fields (``note``, ``velocity``, ``control``, ``value``).
    """
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"MThd":
        raise ValueError(f"{path} is not a standard MIDI file")
    header_len = int.from_bytes(data[4:8], "big")
    division = int.from_bytes(data[12:14], "big")
    if division & 0x8000:
        raise NotImplementedError("SMPTE time division is not supported")
    ticks_per_beat = division or 480

    # Collect raw events from every track, then merge by tick.
    pos = 8 + header_len
    merged = []
    order = 0
    while pos + 8 <= len(data):
        chunk_type = data[pos:pos + 4]
        chunk_len = int.from_bytes(data[pos + 4:pos + 8], "big")
        body = data[pos + 8:pos + 8 + chunk_len]
        pos += 8 + chunk_len
        if chunk_type != b"MTrk":
            continue
        for tick, kind, payload in _parse_track(body):
            merged.append((tick, order, kind, payload))
            order += 1
    merged.sort(key=lambda e: (e[0], e[1]))

    # Convert ticks to seconds with the tempo map.
    messages = []
    seconds, last_tick, tempo = 0.0, 0, _DEFAULT_TEMPO
    for tick, _, kind, payload in merged:
        seconds += (tick - last_tick) * tempo / (1e6 * ticks_per_beat)
        last_tick = tick
        if kind == "set_tempo":
            tempo = payload
            continue
        if kind in ("note_on", "note_off"):
            channel, note, velocity = payload
            messages.append({"time": seconds, "type": kind,
                             "note": note, "velocity": velocity})
        elif kind == "control_change":
            channel, control, value = payload
            messages.append({"time": seconds, "type": "control_change",
                             "control": control, "value": value})
    return messages


def load_notes_midi(midi_path):
    """Extract (pitches, velocities, intervals) with sustain-pedal extension.

    Offset semantics match the reference walk
    (``SoloMultiPitch/MAESTRO.py:118-201``): a note ends at the next event of
    the same pitch; if the sustain pedal is down at that point, the offset
    extends to the next sustain release (or another same-pitch event),
    falling back to the final event.
    """
    messages = parse_midi_messages(midi_path)

    events = []
    sustain_status = False
    for message in messages:
        if message["type"] == "control_change" and message["control"] == 64:
            sustain_on = message["value"] >= 64
            if sustain_on != sustain_status:
                sustain_status = sustain_on
                events.append(dict(index=len(events), time=message["time"],
                                   type="sustain_on" if sustain_on else "sustain_off",
                                   note=None, velocity=0))
        elif message["type"] in ("note_on", "note_off"):
            velocity = message["velocity"] if message["type"] == "note_on" else 0
            events.append(dict(index=len(events), time=message["time"],
                               type="note", note=message["note"],
                               velocity=velocity, sustain=sustain_status))

    pitches, velocities, onsets, offsets = [], [], [], []
    n = len(events)
    for i, onset in enumerate(events):
        if onset["velocity"] == 0:
            continue
        offset = None
        for candidate in events[i + 1:]:
            if candidate["note"] == onset["note"]:
                offset = candidate
                break
        if offset is None and n:
            offset = events[-1]
        if offset.get("sustain", False) and offset is not events[-1]:
            extended = None
            for candidate in events[offset["index"] + 1:]:
                if (candidate["type"] == "sustain_off"
                        or candidate["note"] == onset["note"]):
                    extended = candidate
                    break
            offset = extended if extended is not None else events[-1]
        pitches.append(onset["note"])
        velocities.append(onset["velocity"])
        onsets.append(onset["time"])
        offsets.append(offset["time"])

    intervals = np.stack([np.asarray(onsets, np.float64),
                          np.asarray(offsets, np.float64)], axis=-1) \
        if pitches else np.empty((0, 2))
    return (np.asarray(pitches, np.float64),
            np.asarray(velocities, np.float64),
            intervals)
