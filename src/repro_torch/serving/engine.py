"""Persistent serving engine — the paper's execution model applied to LM
inference, ported to PyTorch (counterpart of ``repro.serving.engine``).

Boot once: weights, KV caches and slot metadata become the device-resident
state of a ``PersistentRuntime``. Each decode step is then triggered by a
mailbox descriptor only (DESC_WIDTH int32s) and runs ONE lockstep decode
for all slots (continuous batching with static shapes).

The engine is a client of the shared Dispatcher: ``decode``, ``insert``,
``prefill`` (when chunked) and ``release`` are opcodes in the runtime's
work table, and every step flows submit → ticket → trigger → retire →
resolve through the dispatcher's queue and mailbox record. Staging is
per-slot: the prefill→decode handoff area holds one batch row per slot,
and the OP_INSERT that copies a finished prefill's row into the main
caches is chained onto the prefill ticket's ``on_complete``.

Differences from the reference, all forced by eager PyTorch on one CUDA
stream:

* State is updated IN PLACE. The weights are adopted, never copied (a
  copy of llama3-8b's bf16 weights is another 16 GB); decode writes the
  caches at each slot's position; the host prefill stages its caches, its
  first token and its length into the slot's staging row with in-place
  copies. Everything is enqueued on the current stream, so host-side
  staging is ordered after every step already in flight.
* Host prefill is a plain call at the prompt's exact length (no per-length
  compile cache); chunked prefill's per-token loop is a host loop, since
  the chunk's start and length are host ints read from the descriptor.
* Argmax tokens stay on the device until the runtime reads the step's
  block back; insert/decode results are therefore host tensors by the
  time a ticket resolves.
* A vlm request (``vision_embeds`` extras) counts its image prefix in its
  slot: the prefill writes ``vision_tokens + L`` cache rows, so the slot
  starts at that length and decode writes at ``vision_tokens + L``,
  ``vision_tokens + L + 1``, ... — the reference model's contract (its
  own model tests decode there). The reference engine stages ``L`` and
  so decodes inside the prefix; the port does not copy that.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.core import mailbox as mb
from repro_torch.core.dispatcher import Dispatcher, Ticket
from repro_torch.core.persistent import PersistentRuntime, check_device
from repro_torch.core.sched import (CRIT_HIGH, CRIT_LOW, BudgetedServerPolicy,
                                    ClassSpec, SchedPolicy)
from repro_torch.core.telemetry import EV_ENGINE, TraceCollector, span
from repro_torch.core.wcet import WcetTracker
from repro_torch.serving.kv_cache import (PH_DECODING, PH_FINISHED,
                                          SlotManager, extract_slot_caches,
                                          insert_slot_caches,
                                          zeros_like_slot)

OP_DECODE = 0
OP_INSERT = 1
OP_PREFILL = 2          # present only when chunked_prefill=True
# OP_RELEASE is always the LAST opcode in the work table — read it from
# ``engine.op_release`` (2 without chunked prefill, 3 with).

# Decode is the latency-critical class: HIGH criticality and, under the
# budgeted-server policy, a guaranteed 80%-bandwidth server.
DECODE_BUDGET_US = 80_000.0
DECODE_PERIOD_US = 100_000.0


class ServingEngine:
    def __init__(self, model, params, *, max_batch: int, max_seq: int,
                 prefill_bucket: int = 64, eos_id: int = -1,
                 tracker: Optional[WcetTracker] = None,
                 dispatcher: Optional[Dispatcher] = None,
                 cluster_id: int = 0, max_inflight: int = 2,
                 max_steps: int = 8,
                 completion_window: Optional[int] = None,
                 policy: Union[str, SchedPolicy, None] = None,
                 decode_budget_us: float = DECODE_BUDGET_US,
                 decode_period_us: float = DECODE_PERIOD_US,
                 chunked_prefill: bool = False,
                 prefill_chunk_tokens: Optional[int] = None,
                 prefill_chunk_us: Optional[float] = None,
                 telemetry: Optional[TraceCollector] = None,
                 device="cuda"):
        if telemetry is not None and dispatcher is not None:
            raise ValueError(
                "telemetry configures the engine-owned dispatcher; attach "
                "the collector to the shared Dispatcher instead "
                "(dispatcher.attach_telemetry)")
        if completion_window is not None:
            if dispatcher is not None:
                raise ValueError(
                    "completion_window configures the engine-owned "
                    "dispatcher; set it on the shared Dispatcher instead")
            if completion_window < 1:
                raise ValueError("completion_window must be >= 1")
        if policy is not None and dispatcher is not None:
            raise ValueError(
                "policy configures the engine-owned dispatcher; set it on "
                "the shared Dispatcher instead")
        self.device = dev = check_device(device)
        if model.device != dev:
            raise ValueError(f"model lives on {model.device}, engine on {dev}")
        self.model = model
        self.cfg = model.cfg
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.prefill_bucket = prefill_bucket
        self.eos_id = eos_id
        self.slots = SlotManager(max_batch)
        self.tracker = tracker or WcetTracker("engine")
        self.cluster = cluster_id
        self.chunked_prefill = bool(chunked_prefill)
        self.prefill_chunk_tokens = int(prefill_chunk_tokens
                                        if prefill_chunk_tokens is not None
                                        else prefill_bucket)
        if self.prefill_chunk_tokens < 1:
            raise ValueError("prefill_chunk_tokens must be >= 1")

        i32 = dict(dtype=torch.int32, device=dev)
        # PER-SLOT prefill→decode handoff area: one staging row per slot
        # (batch-1 caches at the slot's batch index, first token, prompt
        # length — plus the staged prompt when prefill runs device-side)
        staging = {
            "caches": model.init_caches(max_batch, max_seq),
            "token": torch.zeros((max_batch,), **i32),
            "length": torch.zeros((max_batch,), **i32),
        }
        if self.chunked_prefill:
            staging["prompt"] = torch.zeros((max_batch, max_seq), **i32)
        state = {
            "params": params,        # adopted, not copied
            "caches": model.init_caches(max_batch, max_seq),
            "tokens": torch.zeros((max_batch, 1), **i32),
            "lengths": torch.zeros((max_batch,), **i32),
            "active": torch.zeros((max_batch,), dtype=torch.bool, device=dev),
            "staging": staging,
        }

        def decode_fn(state, desc):
            logits, _ = model.decode_step(
                state["params"], state["caches"], state["tokens"],
                state["lengths"])
            nxt = torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32)
            act = state["active"]
            state["tokens"].copy_(
                torch.where(act[:, None], nxt[:, None], state["tokens"]))
            state["lengths"].add_(act.to(torch.int32))
            return state, nxt

        def insert_fn(state, desc):
            slot = int(desc[mb.W_ARG0])
            stg = state["staging"]
            insert_slot_caches(state["caches"],
                               extract_slot_caches(stg["caches"], slot), slot)
            state["tokens"][slot:slot + 1, 0].copy_(stg["token"][slot:slot + 1])
            state["lengths"][slot:slot + 1].copy_(stg["length"][slot:slot + 1])
            state["active"][slot] = True
            # the result is the post-insert token column: row ``slot`` is
            # the request's FIRST generated token (cloned: the column is
            # overwritten in place by later steps)
            return state, state["tokens"][:, 0].clone()

        def release_fn(state, desc):
            # deactivate a slot device-side: decode steps stop advancing
            # its row; its caches are overwritten by the next insert there
            state["active"][int(desc[mb.W_ARG0])] = False
            return state, torch.zeros((max_batch,), **i32)

        chunk_tokens = self.prefill_chunk_tokens

        def prefill_fn(state, carry, desc):
            # chunk-aware (resumable) prefill against the slot's OWN
            # staging row: chunk k folds prompt tokens [k*chunk_tokens, ...)
            # through decode_step on the row's batch-1 caches (views into
            # the staging caches, updated in place). Chunk 0 zeroes the
            # row; the running last-sampled token lives in
            # staging["token"][slot], so the remainder is re-triggerable
            # from the descriptor's chunk word alone.
            stg = state["staging"]
            slot = int(desc[mb.W_ARG0])
            chunk = int(desc[mb.W_CHUNK])
            length = int(desc[mb.W_SEQLEN])
            start = chunk * chunk_tokens
            if chunk == 0:
                zeros_like_slot(stg["caches"], slot)
            row = extract_slot_caches(stg["caches"], slot)
            last = None
            for pos in range(start, start + min(max(length - start, 0),
                                                chunk_tokens)):
                tok = stg["prompt"][slot:slot + 1, pos:pos + 1]
                logits, _ = model.decode_step(
                    state["params"], row, tok,
                    torch.full((1,), pos, **i32))
                last = torch.argmax(logits[0, 0]).to(torch.int32)
            if last is not None:
                stg["token"][slot:slot + 1].copy_(last.reshape(1))
            stg["length"][slot] = length
            done = chunk + 1 >= int(desc[mb.W_NCHUNKS])
            return state, carry, torch.zeros((max_batch,), **i32), done

        work_fns = [("decode", decode_fn), ("insert", insert_fn)]
        if self.chunked_prefill:
            work_fns.append(("prefill", prefill_fn,
                             torch.zeros((), dtype=torch.int32)))
        work_fns.append(("release", release_fn))
        self.op_release = len(work_fns) - 1
        self.rt = PersistentRuntime(
            work_fns,
            result_template=torch.zeros((max_batch,), **i32),
            tracker=self.tracker, max_inflight=max_inflight,
            max_steps=max_steps, telemetry=telemetry, device=dev)
        if telemetry is not None:
            self.rt.telemetry_cluster = cluster_id
        self.rt.boot(state)

        # decode is HIGH-criticality and (under the server policy) runs in
        # its own bandwidth server; insert/release are best-effort LOW;
        # chunked prefill is LOW and DECLARES its chunk length
        class_specs = (
            ClassSpec(opcode=OP_DECODE, name="decode", priority=0,
                      criticality=CRIT_HIGH, budget_us=decode_budget_us,
                      period_us=decode_period_us),
            ClassSpec(opcode=OP_INSERT, name="insert", priority=10,
                      criticality=CRIT_LOW),
        )
        if self.chunked_prefill:
            class_specs += (
                ClassSpec(opcode=OP_PREFILL, name="prefill", priority=5,
                          criticality=CRIT_LOW,
                          chunk_us=prefill_chunk_us),)
        class_specs += (
            ClassSpec(opcode=self.op_release, name="release", priority=10,
                      criticality=CRIT_LOW),)
        if dispatcher is None:
            if policy == "server":
                # work-conserving bandwidth servers: budget isolation
                # throttles decode only when insert work competes
                policy = BudgetedServerPolicy(work_conserving=True)
            dispatcher = Dispatcher(
                {cluster_id: self.rt},
                completion_window=completion_window
                if completion_window is not None else 1024,
                policy=policy, classes=class_specs,
                telemetry=telemetry)
        else:
            dispatcher.register(cluster_id, self.rt)
            for spec in class_specs:
                if dispatcher.policy.spec(spec.opcode) is None:
                    dispatcher.set_class(spec)
        self.dispatcher = dispatcher
        self._step_counter = 0
        # outstanding prefill tickets per slot
        self.prefill_tickets: dict[int, Ticket] = {}

    # ------------------------------------------------------------------
    def _stage(self, slot_caches, first_token, length: int, slot: int):
        """Host prefill → the slot's staging row, in place on the stream."""
        stg = self.rt.state["staging"]
        insert_slot_caches(stg["caches"], slot_caches, slot)
        stg["token"][slot:slot + 1].copy_(first_token.reshape(1))
        stg["length"][slot] = length

    def _set_prompt(self, prompt: np.ndarray, slot: int):
        self.rt.state["staging"]["prompt"][slot].copy_(
            torch.from_numpy(prompt))

    def _prefill(self, batch: dict, length: int):
        # exact-length prefill (the reference compiles one program per
        # distinct length; eager PyTorch needs no cache)
        return self.model.prefill(self.rt.state["params"], batch,
                                  max_seq=self.max_seq)

    def _pump_cluster(self) -> list:
        """Run this engine's cluster queue to empty; returns completions."""
        out = []
        d = self.dispatcher
        while d.queue_depth(self.cluster) or d.inflight_depth(self.cluster):
            comp = d.pump(self.cluster)
            if comp is not None:
                out.append(comp)
        return out

    # ------------------------------------------------------------------
    def _submit_insert(self, request_id: int, slot: int,
                       slot_obj) -> Ticket:
        """Submit the staging→main-cache OP_INSERT for ``slot`` and chain
        the host-side bookkeeping onto its resolution (the slot flips to
        ``decoding`` and records its first generated token)."""
        ticket = self.dispatcher.submit(
            mb.WorkDescriptor(opcode=OP_INSERT, arg0=slot,
                              request_id=request_id),
            cluster=self.cluster, admission=False)
        tc = self.dispatcher.telemetry

        def _on_insert(comp, slot=slot, slot_obj=slot_obj):
            slot_obj.generated.append(int(np.asarray(comp.result)[slot]))
            slot_obj.phase = PH_DECODING
            if tc is not None:
                tc.emit(EV_ENGINE, cluster=self.cluster,
                        request_id=comp.request_id, phase="insert",
                        slot=slot)

        ticket.on_complete(_on_insert)
        return ticket

    def add_request(self, request_id: int, prompt: np.ndarray,
                    max_new_tokens: int = 32,
                    extras: Optional[dict] = None) -> Optional[int]:
        """Prefill a prompt into a free slot. Returns the slot or None.

        NON-BLOCKING: returns at submission time. With ``chunked_prefill``
        the prompt runs as a chunked OP_PREFILL item through the
        dispatcher and the OP_INSERT is chained onto its resolution;
        otherwise the host runs the prefill here (enqueued on the stream)
        and submits the insert. A prompt with ``extras`` (encdec frames,
        vlm ``vision_embeds``: {name: array without the batch axis})
        always takes the host prefill, which receives them as batch-1
        tensors on the engine's device. A vlm request's slot holds its
        ``vision_tokens`` prefix rows before the prompt's; raises
        ValueError when prefix, prompt and new tokens do not fit
        ``max_seq``."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        L = int(prompt.shape[0])
        V = self.cfg.vision_tokens if extras and "vision_embeds" in extras \
            else 0
        if V and V + L + max_new_tokens - 1 > self.max_seq - 1:
            raise ValueError(
                f"request {request_id}: {V} image-prefix rows + {L} prompt "
                f"tokens + {max_new_tokens} new tokens - 1 = "
                f"{V + L + max_new_tokens - 1} exceeds max_seq - 1 = "
                f"{self.max_seq - 1}")
        # the prefill emits the first generated token, so the decode loop
        # contributes max_new_tokens - 1 more
        slot = self.slots.allocate(
            request_id, V + L,
            min(V + L + max_new_tokens - 1, self.max_seq - 1))
        if slot is None:
            return None
        slot_obj = self.slots.slots[slot]
        chunked = self.chunked_prefill and not extras
        tc = self.dispatcher.telemetry
        if tc is not None:
            tc.emit(EV_ENGINE, cluster=self.cluster, request_id=request_id,
                    phase="add_request", slot=slot, prompt_tokens=L,
                    path="chunked" if chunked else "host")
        if chunked:
            buf = np.zeros((self.max_seq,), np.int32)
            buf[:L] = prompt
            self._set_prompt(buf, slot)
            n_chunks = -(-L // self.prefill_chunk_tokens)
            ticket = self.dispatcher.submit(
                mb.WorkDescriptor(opcode=OP_PREFILL, arg0=slot, seq_len=L,
                                  request_id=request_id,
                                  n_chunks=n_chunks),
                cluster=self.cluster, admission=False)
            self.prefill_tickets[slot] = ticket

            def _chain(_comp, rid=request_id, slot=slot, slot_obj=slot_obj):
                self.prefill_tickets.pop(slot, None)
                self._submit_insert(rid, slot, slot_obj)

            ticket.on_complete(_chain)
        else:
            with span("repro_torch.engine.prefill", request_id):
                batch = {"tokens":
                         torch.from_numpy(prompt[None]).to(self.device)}
                if extras:
                    batch.update({k: torch.from_numpy(np.asarray(v)[None]).to(
                        self.device) for k, v in extras.items()})
                logits, caches = self._prefill(batch, L)
                first = torch.argmax(logits[0, -1, :]).to(torch.int32)
                self._stage(caches, first, V + L, slot)
            if tc is not None:
                tc.emit(EV_ENGINE, cluster=self.cluster,
                        request_id=request_id, phase="host_prefill",
                        slot=slot, path="host", prompt_tokens=L)
            self._submit_insert(request_id, slot, slot_obj)
        return slot

    def release_slot(self, slot: int, request_id: int = -1) -> Ticket:
        """Deactivate ``slot`` device-side (OP_RELEASE). The host record
        is untouched — free it when the returned ticket resolves."""
        return self.dispatcher.submit(
            mb.WorkDescriptor(opcode=self.op_release, arg0=slot,
                              request_id=request_id),
            cluster=self.cluster, admission=False)

    # ------------------------------------------------------------------
    def step(self, deadline_us: int = 0,
             auto_free: bool = True) -> dict[int, int]:
        """One persistent decode step through the dispatcher; returns
        {slot: new_token} for DECODING slots. ``deadline_us`` gives the
        step a real EDF deadline; ``auto_free=False`` parks exhausted
        slots in phase ``finished`` instead of freeing them."""
        rid = self._step_counter
        with span("repro_torch.engine.step", rid):
            desc = mb.WorkDescriptor(work_id=rid % 1024, opcode=OP_DECODE,
                                     request_id=rid, deadline_us=deadline_us)
            self._step_counter += 1
            ticket = self.dispatcher.submit(desc, cluster=self.cluster,
                                            admission=False)
            toks = np.asarray(ticket.result())
            out = {}
            for i in self.slots.decoding_indices():
                s = self.slots.slots[i]
                t = int(toks[i])
                s.generated.append(t)
                s.length += 1
                out[i] = t
                if t == self.eos_id or s.length >= s.max_len:
                    if auto_free:
                        self.slots.free(i)
                    else:
                        s.phase = PH_FINISHED
        return out

    # ------------------------------------------------------------------
    def generate(self, prompts: list[np.ndarray], max_new_tokens: int = 16,
                 extras: Optional[list] = None) -> list[list[int]]:
        """Simple driver: admit all (queueing when full), decode until done
        (continuous batching: freed slots are refilled between steps).
        ``extras``: one dict a prompt (see ``add_request``), or None."""
        queue = deque(enumerate(prompts))
        record: dict[int, Any] = {}

        def admit():
            while queue:
                rid, p = queue[0]
                ex = extras[rid] if extras else None
                slot = self.add_request(rid, p, max_new_tokens, ex)
                if slot is None:
                    return
                record[rid] = self.slots.slots[slot]
                queue.popleft()

        admit()
        while self.slots.any_active or queue:
            self.step()
            admit()
        return [record[r].generated for r in range(len(prompts))]

    def dispose(self):
        self._pump_cluster()        # retire any leftovers before detaching
        if self.cluster in self.dispatcher.runtimes:
            self.dispatcher.unregister(self.cluster)
        self.rt.dispose()
