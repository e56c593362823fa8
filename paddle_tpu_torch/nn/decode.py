"""Sequence decoding — port of ``paddle_tpu.nn.decode``: ``Decoder``,
``BeamSearchDecoder``, ``dynamic_decode`` and the sampling helpers
(``DecodeHelper``, ``TrainingHelper``, ``GreedyEmbeddingHelper``,
``SampleEmbeddingHelper``, ``BasicDecoder``).

``dynamic_decode`` is a loop on the host, as the JAX package's eager path
is: one decoder step after another until every sequence has finished or
``max_step_num + 1`` steps ran (one device-to-host read of the finished
flags a step), the outputs stacked over the steps that ran.  The JAX
package runs one ``lax.while_loop`` into preallocated buffers and, when
eager, slices them to the same steps (ROADMAP §C).

Beam search keeps the JAX semantics: beam 0 live and the others at
``-1e9`` at the start, a finished beam's mass all on ``end_token``, the
top ``beam_size`` of ``beam · vocab`` scores per batch row, lengths that
count the step that emitted ``end_token``.  Among equal scores the top-k
takes the lower index first, as ``jax.lax.top_k`` does — a stable
descending sort, not ``torch.topk``, which promises no order for ties on
the card; ties are exact whenever dead or finished beams meet (``-1e9``
absorbs a float32 log-probability).  Ids, parents and lengths are int64
(the port's integer kind, ROADMAP §C).
"""
from __future__ import annotations

import collections

import torch

from ..framework.random import generator_for
from ..tensor._common import t as _t
from .functional.extension import gather_tree

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode",
           "DecodeHelper", "TrainingHelper", "GreedyEmbeddingHelper",
           "SampleEmbeddingHelper", "BasicDecoder"]

_KINF = 1e9


def _map(fn, *trees):
    """``fn`` over matching tensors of nested tuples / lists / namedtuples
    (``None`` passes through)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_map(fn, *parts) for parts in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for part in tree for leaf in _leaves(part)]
    return [tree]


class Decoder:
    """A decode-step provider for :func:`dynamic_decode`: ``initialize``
    → (inputs, states, finished); ``step`` → (outputs, next_states,
    next_inputs, finished); optionally ``finalize``."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


def _stable_top_k(scores, k):
    """The k largest of each row, the lower index first among equal
    scores (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(scores, dim=1, descending=True, stable=True)
    return values[:, :k], indices[:, :k]


class BeamSearchDecoder(Decoder):
    """Beam search over ``cell`` (which sees merged ``[batch · beam,
    ...]`` tensors); the beam bookkeeping runs in ``[batch, beam, ...]``."""

    OutputWrapper = collections.namedtuple(
        "OutputWrapper", ("scores", "predicted_ids", "parent_ids"))
    StateWrapper = collections.namedtuple(
        "StateWrapper", ("cell_states", "log_probs", "finished", "lengths"))

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """``[batch, ...]`` → ``[batch · beam, ...]``, each entry repeated
        ``beam_size`` times (attention memories and the like)."""
        return torch.repeat_interleave(_t(x), beam_size, dim=0)

    def _split_batch_beams(self, x):
        return x.reshape((-1, self.beam_size) + tuple(x.shape[1:]))

    def _merge_batch_beams(self, x):
        return x.reshape((-1,) + tuple(x.shape[2:]))

    def _expand_to_beam_size(self, x):
        x = _t(x)
        return x.unsqueeze(1).expand(
            (x.shape[0], self.beam_size) + tuple(x.shape[1:]))

    def _gather(self, x, indices):
        """``x[b, indices[b, j], ...]`` for ``x`` ``[batch, beam, ...]``."""
        idx = indices.reshape(tuple(indices.shape) + (1,) * (x.dim() - 2))
        return torch.gather(x, 1, idx.expand(tuple(indices.shape)
                                             + tuple(x.shape[2:])))

    def initialize(self, initial_cell_states):
        states = _map(self._expand_to_beam_size, initial_cell_states)
        leaf = _leaves(initial_cell_states)[0]
        batch, dev = leaf.shape[0], leaf.device
        init_ids = torch.full((batch, self.beam_size), self.start_token,
                              dtype=torch.int64, device=dev)
        log_probs = torch.tensor(
            [[0.0] + [-_KINF] * (self.beam_size - 1)], dtype=torch.float32,
            device=dev).repeat(batch, 1)
        finished = torch.zeros((batch, self.beam_size), dtype=torch.bool,
                               device=dev)
        lengths = torch.zeros((batch, self.beam_size), dtype=torch.int64,
                              device=dev)
        inputs = self.embedding_fn(init_ids) if self.embedding_fn else \
            init_ids
        return inputs, self.StateWrapper(states, log_probs, finished,
                                         lengths), finished

    def _beam_search_step(self, time, logits, next_cell_states, beam_state):
        vocab = logits.shape[-1]
        step_log_probs = torch.log_softmax(logits.float(), dim=-1)
        noend = torch.full((vocab,), -_KINF, dtype=torch.float32,
                           device=logits.device)
        noend[self.end_token] = 0.0
        step_log_probs = torch.where(beam_state.finished[:, :, None], noend,
                                     step_log_probs)
        log_probs = step_log_probs + beam_state.log_probs[:, :, None]
        scores = log_probs.reshape(-1, self.beam_size * vocab)
        topk_scores, topk_indices = _stable_top_k(scores, self.beam_size)
        beam_indices = topk_indices // vocab
        token_indices = topk_indices % vocab
        next_cell_states = _map(lambda x: self._gather(x, beam_indices),
                                next_cell_states)
        next_finished = self._gather(beam_state.finished, beam_indices)
        next_lengths = (self._gather(beam_state.lengths, beam_indices)
                        + (~next_finished).long())
        next_finished = next_finished | (token_indices == self.end_token)
        output = self.OutputWrapper(topk_scores, token_indices, beam_indices)
        state = self.StateWrapper(next_cell_states, topk_scores,
                                  next_finished, next_lengths)
        return output, state

    def step(self, time, inputs, states, **kwargs):
        inputs = _map(self._merge_batch_beams, inputs)
        cell_states = _map(self._merge_batch_beams, states.cell_states)
        cell_outputs, next_cell_states = self.cell(inputs, cell_states,
                                                   **kwargs)
        cell_outputs = _map(self._split_batch_beams, cell_outputs)
        next_cell_states = _map(self._split_batch_beams, next_cell_states)
        if self.output_fn is not None:
            cell_outputs = self.output_fn(cell_outputs)
        output, state = self._beam_search_step(time, cell_outputs,
                                               next_cell_states, states)
        ids = output.predicted_ids
        next_inputs = self.embedding_fn(ids) if self.embedding_fn else ids
        return output, state, next_inputs, state.finished

    def finalize(self, outputs, final_states, sequence_lengths):
        return gather_tree(outputs.predicted_ids,
                           outputs.parent_ids), final_states

    @property
    def tracks_own_finished(self):
        return True


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Run ``decoder`` until every sequence finishes or ``max_step_num +
    1`` steps ran (``max_step_num`` defaults to 255); returns
    ``(outputs, final_states)`` (``return_length``: and the per-sequence
    lengths, counting the step that finished a sequence).  Outputs are
    ``[batch, time, ...]`` (``output_time_major``: ``[time, batch,
    ...]``), finalized by the decoder where it can.  ``impute_finished``
    keeps the states of sequences that had finished before a step."""
    max_steps = int(255 if max_step_num is None else max_step_num) + 1
    inputs, states, finished = decoder.initialize(inits)
    finished = _t(finished)
    seq_lens = torch.zeros(finished.shape, dtype=torch.int64,
                           device=finished.device)
    steps = []
    time = 0
    while time < max_steps and not bool(finished.all()):
        outputs, next_states, next_inputs, step_finished = decoder.step(
            time, inputs, states, **kwargs)
        step_finished = _t(step_finished)
        next_finished = (step_finished if decoder.tracks_own_finished
                         else step_finished | finished)
        seq_lens = seq_lens + (~finished).long()
        if impute_finished:
            done = finished

            def keep(old, new):
                mask = done.reshape(tuple(done.shape)
                                    + (1,) * (new.dim() - done.dim()))
                return torch.where(mask, old, new)

            next_states = _map(keep, states, next_states)
        steps.append(outputs)
        time += 1
        inputs, states, finished = next_inputs, next_states, next_finished
    if not steps:  # every sequence finished at the start: no step ran
        with torch.no_grad():
            probe = decoder.step(0, inputs, states, **kwargs)[0]
        final_outputs = _map(lambda o: o.new_empty((0,) + tuple(o.shape)),
                             probe)
    else:
        final_outputs = _map(lambda *os: torch.stack(os), *steps)
    try:
        final_outputs, states = decoder.finalize(final_outputs, states,
                                                 seq_lens)
    except NotImplementedError:
        pass
    if not output_time_major:
        final_outputs = _map(lambda o: o.transpose(0, 1), final_outputs)
    if return_length:
        return final_outputs, states, seq_lens
    return final_outputs, states


class DecodeHelper:
    """The sampling protocol of :class:`BasicDecoder`: ``initialize() ->
    (inputs, finished)``; ``sample(time, outputs, states) -> ids``;
    ``next_inputs(time, outputs, states, ids) -> (finished, inputs,
    states)``."""

    def initialize(self):
        raise NotImplementedError

    def sample(self, time, outputs, states):
        raise NotImplementedError

    def next_inputs(self, time, outputs, states, sample_ids):
        raise NotImplementedError


class TrainingHelper(DecodeHelper):
    """Teacher forcing: step t's input is ``inputs[:, t]`` (``[t]`` with
    ``time_major``, the last step's past the end); a sequence finishes
    when the next step reaches its ``sequence_length``."""

    def __init__(self, inputs, sequence_length, time_major=False):
        self.inputs = inputs
        self.sequence_length = _t(sequence_length)
        self.time_major = bool(time_major)
        self._axis = 0 if self.time_major else 1

    def _slice(self, t):
        def take(x):
            x = _t(x)
            return x.select(self._axis, min(int(t), x.shape[self._axis] - 1))
        return _map(take, self.inputs)

    def initialize(self):
        return self._slice(0), self.sequence_length == 0

    def sample(self, time, outputs, states):
        return outputs.argmax(-1)

    def next_inputs(self, time, outputs, states, sample_ids):
        next_time = int(time) + 1
        return (next_time >= self.sequence_length, self._slice(next_time),
                states)


class GreedyEmbeddingHelper(DecodeHelper):
    """Greedy decoding: the argmax id, embedded by ``embedding_fn``, is
    the next input; a sequence finishes at ``end_token``."""

    def __init__(self, embedding_fn, start_tokens, end_token):
        self.embedding_fn = embedding_fn
        self.start_tokens = _t(start_tokens).long()
        self.end_token = int(end_token)

    def initialize(self):
        finished = torch.zeros(self.start_tokens.shape[:1], dtype=torch.bool,
                               device=self.start_tokens.device)
        return self.embedding_fn(self.start_tokens), finished

    def sample(self, time, outputs, states):
        return outputs.argmax(-1)

    def next_inputs(self, time, outputs, states, sample_ids):
        return (sample_ids == self.end_token, self.embedding_fn(sample_ids),
                states)


class SampleEmbeddingHelper(GreedyEmbeddingHelper):
    """Sampling from each step's softmax (logits over
    ``softmax_temperature``).  Unseeded: draws from the generator of the
    outputs' device, so two runs differ; ``seed``: from a generator seeded
    with it afresh for each run."""

    def __init__(self, embedding_fn, start_tokens, end_token,
                 softmax_temperature=None, seed=None):
        super().__init__(embedding_fn, start_tokens, end_token)
        self.temperature = softmax_temperature
        self._seed = seed
        self._gen = None

    def initialize(self):
        self._gen = None
        return super().initialize()

    def sample(self, time, outputs, states):
        logits = (outputs if self.temperature is None
                  else outputs / self.temperature)
        if self._gen is None:
            self._gen = (generator_for(logits.device) if self._seed is None
                         else torch.Generator(logits.device).manual_seed(
                             int(self._seed)))
        probs = torch.softmax(logits.float(), -1)
        return torch.multinomial(probs, 1, generator=self._gen).squeeze(-1)


class BasicDecoder(Decoder):
    """A cell and a helper: a step is the cell call, ``output_fn``, the
    helper's sample and next inputs; outputs are ``OutputWrapper(
    cell_outputs, sample_ids)``."""

    OutputWrapper = collections.namedtuple(
        "OutputWrapper", ("cell_outputs", "sample_ids"))

    def __init__(self, cell, helper: DecodeHelper, output_fn=None):
        self.cell = cell
        self.helper = helper
        self.output_fn = output_fn

    def initialize(self, initial_cell_states):
        initial_inputs, initial_finished = self.helper.initialize()
        return initial_inputs, initial_cell_states, initial_finished

    def step(self, time, inputs, states, **kwargs):
        cell_outputs, cell_states = self.cell(inputs, states, **kwargs)
        if self.output_fn is not None:
            cell_outputs = self.output_fn(cell_outputs)
        sample_ids = self.helper.sample(time, cell_outputs, cell_states)
        finished, next_inputs, next_states = self.helper.next_inputs(
            time, cell_outputs, cell_states, sample_ids)
        return (BasicDecoder.OutputWrapper(cell_outputs, sample_ids),
                next_states, next_inputs, finished)
