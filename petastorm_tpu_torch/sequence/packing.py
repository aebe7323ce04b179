"""Greedy sequence packing: many variable-length rows -> few dense token slots.

Twin of ``petastorm_tpu/sequence/packing.py``: the same bins, arrays and
efficiency accounting.

Padding pays for the LONGEST row in every batch; packing instead concatenates
whole sequences into fixed ``tokens_per_batch`` slots (first-fit-decreasing —
the classic bin-packing heuristic, within 22% of optimal in the worst case and
far closer on zipf-ish length mixes), emitting per-token ``segment_ids`` and
``positions`` arrays so block-diagonal attention masks and per-segment
position embeddings can be reconstructed downstream. A slot's pad tail is
``segment_ids == 0``.

Efficiency is accounted per batch and cumulatively
(``packing_efficiency`` = real tokens / slot capacity).

Determinism: packing decisions are pure functions of the pooled
rows' lengths — no RNG, no wall clock — so a fixed seed upstream reproduces
bit-identical packed batches.
"""

from __future__ import annotations

import numpy as np

from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.errors import PetastormTpuError


def first_fit_decreasing(lengths, capacity):
    """Pack item lengths into bins of ``capacity`` with first-fit-decreasing.

    Returns a list of bins, each a list of item INDICES into ``lengths``
    (bins in creation order; indices in decreasing-length order within a bin,
    ties broken by original index so the result is deterministic).
    Items longer than ``capacity`` raise — truncation is the caller's
    explicit decision (``PadSpec.max_length`` upstream).
    """
    order = sorted(range(len(lengths)), key=lambda i: (-int(lengths[i]), i))
    bins, remaining = [], []
    for i in order:
        n = int(lengths[i])
        if n > capacity:
            raise PetastormTpuError(
                'Sequence of length {} exceeds tokens_per_batch={}; truncate upstream '
                '(PadSpec(max_length=...)) or raise the slot capacity'.format(n, capacity))
        for b, free in enumerate(remaining):
            if n <= free:
                bins[b].append(i)
                remaining[b] -= n
                break
        else:
            bins.append([i])
            remaining.append(capacity - n)
    return bins


def pack_rows(rows, tokens_per_batch, sequence_fields, length_of=None, pad_value=0):
    """Pack row dicts/namedtuples into dense slots.

    :param rows: rows whose ``sequence_fields`` are 1-D (or [L, ...]) arrays
        sharing one length per row
    :param sequence_fields: field names packed along the token axis
    :param length_of: field defining each row's token length (default: first
        of ``sequence_fields``)
    :returns: ``(batch, stats)`` — ``batch`` maps each sequence field to a
        ``[num_slots, tokens_per_batch, ...]`` array plus ``segment_ids`` /
        ``positions`` (int32, same shape, 0-padded; segment ids are 1-based
        per slot) and ``num_segments`` ``[num_slots]``; ``stats`` carries
        ``real_tokens`` / ``slot_tokens`` / ``packing_efficiency``.
    """
    if not rows:
        raise PetastormTpuError('Cannot pack an empty row list')
    rows = [r._asdict() if hasattr(r, '_asdict') else r for r in rows]
    fields = list(sequence_fields)
    length_field = length_of or fields[0]
    lengths = [len(np.asarray(r[length_field])) for r in rows]
    bins = first_fit_decreasing(lengths, tokens_per_batch)

    batch = {}
    for name in fields:
        cells = [np.asarray(r[name]) for r in rows]
        trailing = cells[0].shape[1:]
        out = np.full((len(bins), tokens_per_batch) + trailing, pad_value,
                      dtype=cells[0].dtype)
        for b, members in enumerate(bins):
            cursor = 0
            for i in members:
                n = lengths[i]
                out[b, cursor:cursor + n] = cells[i][:n]
                cursor += n
        batch[name] = out

    segment_ids = np.zeros((len(bins), tokens_per_batch), dtype=np.int32)
    positions = np.zeros((len(bins), tokens_per_batch), dtype=np.int32)
    num_segments = np.zeros(len(bins), dtype=np.int32)
    for b, members in enumerate(bins):
        cursor = 0
        for seg, i in enumerate(members, start=1):
            n = lengths[i]
            segment_ids[b, cursor:cursor + n] = seg
            positions[b, cursor:cursor + n] = np.arange(n, dtype=np.int32)
            cursor += n
        num_segments[b] = len(members)
    batch['segment_ids'] = segment_ids
    batch['positions'] = positions
    batch['num_segments'] = num_segments

    real = int(sum(lengths))
    slot_tokens = len(bins) * tokens_per_batch
    stats = {'real_tokens': real, 'slot_tokens': slot_tokens,
             'packing_efficiency': round(real / slot_tokens, 4) if slot_tokens else 0.0}
    return batch, stats


class PackedSequenceLoader(object):
    """Iterate a reader as PACKED token batches.

    Pulls rows (row-oriented readers directly; batched readers are transposed
    a block at a time), pools ``pool_rows`` of them, first-fit-decreasing
    packs the pool into ``tokens_per_batch`` slots, and yields batches of
    ``slots_per_batch`` slots. Slots the pool could not fill to a full batch
    return to the pool and re-pack with later arrivals, so mid-stream batches
    stay dense; on reader exhaustion the tail is flushed (or dropped with
    ``drop_last``).

    Non-sequence fields are dropped from the output (a packed slot has no
    single value for them) — project them upstream if needed.

    Checkpointing: :meth:`state_dict` embeds the underlying reader state plus
    the pooled rows, mirroring the
    :class:`~petastorm_tpu_torch.torch.loader.TorchDataLoader` contract.

    :param reader: a :class:`petastorm_tpu_torch.reader.Reader` (row or columnar)
    :param tokens_per_batch: slot capacity in tokens
    :param sequence_fields: fields packed along the token axis
    :param slots_per_batch: slots per yielded batch (the device batch dim)
    :param pool_rows: rows pooled before each packing pass — larger pools
        pack tighter at the cost of latency and checkpoint size
    """

    def __init__(self, reader, tokens_per_batch, sequence_fields,
                 slots_per_batch=8, pool_rows=256, length_of=None, pad_value=0,
                 drop_last=False, resume_state=None):
        if tokens_per_batch < 1 or slots_per_batch < 1 or pool_rows < 1:
            raise ValueError('tokens_per_batch, slots_per_batch and pool_rows must be >= 1')
        self.reader = reader
        self._tokens = tokens_per_batch
        self._fields = list(sequence_fields)
        self._slots = slots_per_batch
        self._pool_rows = pool_rows
        self._length_of = length_of or self._fields[0]
        self._pad_value = pad_value
        self._drop_last = drop_last
        self._pool = []
        self._real_tokens = 0
        self._slot_tokens = 0
        self._batches_out = 0
        if resume_state is not None:
            if not isinstance(resume_state, dict) or resume_state.get('version') != 1:
                raise ValueError('Unrecognized resume_state (expected a dict produced by '
                                 'PackedSequenceLoader.state_dict())')
            self._pool = list(resume_state['rows'])

    def __iter__(self):
        from petastorm_tpu_torch.columnar import block_to_rows
        from petastorm_tpu_torch.torch.loader import _to_plain_row
        for item in self.reader:
            if self.reader.batched_output:
                self._pool.extend(block_to_rows(item._asdict()))
            else:
                self._pool.append(_to_plain_row(item))
            while len(self._pool) >= self._pool_rows:
                batch = self._pack_once(flush=False)
                if batch is None:
                    break  # pool packs to < slots_per_batch full slots: need more rows
                yield batch
        while self._pool:
            batch = self._pack_once(flush=True)
            if batch is None:
                return
            yield batch

    def _pack_once(self, flush):
        lengths = [len(np.asarray(r[self._length_of])) for r in self._pool]
        bins = first_fit_decreasing(lengths, self._tokens)
        if not flush:
            if len(bins) < self._slots + 1:
                # keep one spill bin pooled: the last-opened bin is the least
                # full, so emitting it mid-stream would dilute efficiency
                return None
            emit_bins, spill = bins[:self._slots], bins[self._slots:]
        else:
            emit_bins, spill = bins[:self._slots], bins[self._slots:]
            if self._drop_last and len(emit_bins) < self._slots:
                self._pool = []
                return None
        emitted_rows = [self._pool[i] for b in emit_bins for i in b]
        self._pool = [self._pool[i] for b in spill for i in b]
        batch, stats = pack_rows(emitted_rows, self._tokens, self._fields,
                                 length_of=self._length_of, pad_value=self._pad_value)
        self._real_tokens += stats['real_tokens']
        self._slot_tokens += len(emit_bins) * self._tokens
        self._batches_out += 1
        obs.count('seq_packed_batches_total')
        obs.count('seq_packed_real_tokens_total', stats['real_tokens'])
        obs.gauge_set('packing_efficiency', self.packing_efficiency)
        return batch

    @property
    def packing_efficiency(self):
        """Cumulative real-token fill of all emitted slots (0.0 before the
        first batch)."""
        if not self._slot_tokens:
            return 0.0
        return round(self._real_tokens / self._slot_tokens, 4)

    @property
    def diagnostics(self):
        out = dict(self.reader.diagnostics)
        out.update({
            'packing_efficiency': self.packing_efficiency,
            'packed_batches': self._batches_out,
            'packed_real_tokens': self._real_tokens,
            'packed_slot_tokens': self._slot_tokens,
        })
        return out

    def state_dict(self):
        from petastorm_tpu_torch.torch.loader import _to_plain_row
        return {'version': 1,
                'reader': self.reader.state_dict(),
                'rows': [_to_plain_row(r) for r in self._pool]}

    def stop(self):
        self.reader.stop()

    def join(self):
        self.reader.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, tb):
        self.stop()
        self.join()
