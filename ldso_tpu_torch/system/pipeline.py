"""Pipelined tracking / mapping drivers over a FullSystem.

Counterpart of ldso_tpu/system/pipeline.py, the reference's thread
architecture (FullSystem::deliverTrackedFrame + mappingLoop,
FullSystem.cc:160-177, 1809-1870):

  DeterministicPipeline  tracks up to `depth` frames ahead through the
                         device TrackChain and maps them inline, in order,
                         on a fixed cadence: two runs give the same bits.
  AsyncPipeline          the reference's threaded mode: the caller tracks,
                         a mapping thread consumes the tracked frames with
                         catch-up skipping and makes keyframes when idle.

On the card the mapping thread runs on a CUDA stream of its own and the
tracking side on another. What crosses between them crosses with an event
and `record_stream`: the caller's image when it is already on the card
(caller -> tracking, or -> mapping while bootstrapping), a frame's pyramid
(tracking -> mapping, queued with the event recorded after it) and the
tracking reference (mapping -> tracking, published as one (ref, shell,
event) tuple).

Keyframe policy under load (mappingLoop, FullSystem.cc:1825-1864): a
popped frame becomes a keyframe only when the queue is empty behind it and
a keyframe demand is pending against the current newest keyframe; while
the queue is non-empty every popped frame is a non-keyframe, and in
catch-up mode (queue past KETCHUP_THRESHOLD) every other queued frame is
skipped outright (tracking already set its pose). The demand bookkeeping is
upstream DSO's `needNewKFAfter` (LDSO declares the field, FullSystem.h:310,
but lost the assignment), as in the JAX package.

Not carried over from the JAX package: its relay-only download and upload
threads (`_PackedGroup`, the INGEST_BATCH staging) and the batched chain
program; frames are dispatched one at a time, as the JAX pipeline does
with INGEST_BATCH = 1.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Optional

import torch

from ldso_tpu_torch.loop import posegraph
from ldso_tpu_torch.slam_map import FrameShell
from ldso_tpu_torch.system.full_system import FullSystem, use_on_current_stream
from ldso_tpu_torch.utils.device import record_event


def _on_stream(stream):
    """Run on `stream` (and its device); nothing on the CPU."""
    if stream is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(stream.device))
    stack.enter_context(torch.cuda.stream(stream))
    return stack


def _final_pose_graph(fs: FullSystem):
    """The shutdown pose-graph pass (Map::lastOptimizeAllKFs)."""
    if fs.loop_closing is not None and fs.global_map.num_frames() > 4:
        posegraph.run_pose_graph(fs.global_map, device=fs.device)


class DeterministicPipeline:
    """Speculative lookahead for the synchronous (determinism) mode.

    Dispatches up to `depth` frames against the current tracking reference
    through the TrackChain, consumes their results strictly in order, and
    on a keyframe (or a retrack-gate trip) re-dispatches the frames still in
    flight against the new reference. Every decision depends on the data
    alone, never on which result happens to be ready, so two runs over the
    same frames give identical trajectories. Mapping runs inline at consume
    time, as in the reference's linearizeOperation mode."""

    def __init__(self, fs: FullSystem, depth: int = 3):
        self.fs = fs
        self.depth = depth
        self.pending = collections.deque()  # (shell, image, pyr, packed, ref_shell)
        self._slast = None
        self._sprelast = None
        self.retrack_trips = 0

    def add_active_frame(self, image, frame_id, exposure=1.0, timestamp=0.0):
        fs = self.fs
        if fs.is_lost:
            return None
        if not fs.initialized or fs.tracker_ref is None:
            self._drain_all()
            return fs.add_active_frame(image, frame_id, exposure, timestamp)
        if not self.pending:
            fs.chain_reset()
        shell = FrameShell(id=frame_id, timestamp=timestamp, exposure=exposure)
        shell.pose_valid = False            # until consumed, in order
        fs.all_frames.append(shell)
        pyr, packed, ref_shell = fs.track_chain_dispatch(shell, image)
        self.pending.append((shell, image, pyr, packed, ref_shell))
        # a fixed cadence (one consume per frame once `depth` are in
        # flight), never by readiness: which frames continue the device
        # chain and which rebuild it from the host must depend on the data
        while len(self.pending) > self.depth and not fs.is_lost:
            self._consume_one()
        return shell

    def block_until_mapping_is_finished(self):
        self._drain_all()
        _final_pose_graph(self.fs)

    def _drain_all(self):
        while self.pending and not self.fs.is_lost:
            self._consume_one()

    def _redispatch_inflight(self):
        """The tracking reference or the chain changed: re-dispatch every
        pending frame against it, in order."""
        fs = self.fs
        old = list(self.pending)
        self.pending.clear()
        fs.chain_reset()
        for shell, image, _, _, _ in old:
            pyr, packed, ref_shell = fs.track_chain_dispatch(shell, image)
            self.pending.append((shell, image, pyr, packed, ref_shell))

    def _consume_one(self):
        fs = self.fs
        shell, image, pyr, packed, ref_shell = self.pending.popleft()
        if fs.track_chain_consume(shell, packed, ref_shell):
            shell.pose_valid = True
        else:
            # gate tripped: the host retry sweep against the current ref
            self.retrack_trips += 1
            ok = fs._track_new_coarse(shell, image, commit_trace=False,
                                      neighbors=(self._slast, self._sprelast))
            shell.pose_valid = bool(ok)
            if not ok:
                fs.is_lost = True
                for sh, *_ in self.pending:
                    sh.pose_valid = False
                return
            ref_shell = fs._last_track_ref
            pyr = fs._frame_pyr
            if self.pending:        # the chain continued from a bad pose
                self._redispatch_inflight()
        self._sprelast, self._slast = self._slast, shell
        if fs._keyframe_decision(shell, ref=ref_shell):
            fs.make_keyframe(shell, pyr)
            if fs.is_lost:
                return
            if self.pending:        # a new tracking reference
                self._redispatch_inflight()
        else:
            fs.make_non_keyframe(shell, pyr)


class AsyncPipeline:
    """A FullSystem with the reference's mapping-thread hand-off.

    The caller's thread tracks (add_active_frame); a mapping thread makes
    keyframes and non-keyframes from the queue of tracked frames. A failure
    on the mapping thread is raised on the caller by the next
    add_active_frame and by block_until_mapping_is_finished.
    `linearize_operation=True` runs every frame synchronously (the
    reference's determinism mode)."""

    # catch-up engages when the queue runs past this (FullSystem.cc:1836)
    KETCHUP_THRESHOLD = 3
    # backpressure bound: each queued frame holds its pyramid on the device
    MAX_QUEUE = 32
    # frames dispatched ahead of the consume (a dispatch returns before the
    # card has tracked the frame): the bound caps how stale the tracking
    # reference of a frame in flight can get, as in the JAX package
    CHAIN_DEPTH = 12

    def __init__(self, fs: FullSystem, linearize_operation: bool = False,
                 max_queue: Optional[int] = None):
        self.fs = fs
        self.linearize_operation = linearize_operation
        self.max_queue = max_queue or self.MAX_QUEUE
        self.unmapped = collections.deque()   # (shell, pyr, event)
        self.cond = threading.Condition()
        self.need_new_kf_after = -1           # FullSystem.h:310
        self.need_ketchup = False
        self.running = not linearize_operation
        self.exc: Optional[BaseException] = None
        self._map_lock = threading.Lock()
        self.pending = collections.deque()    # (shell, image, pyr, packed, ref_shell)
        self._chain_dirty = True
        self._slast = None
        self._sprelast = None
        self._kf_finish = None    # deferred keyframe finish (mapping thread)
        self.retrack_trips = 0
        self.track_stream = self.map_stream = None
        if fs.device.type == "cuda":
            current = torch.cuda.current_stream(fs.device)
            self.track_stream = torch.cuda.Stream(fs.device)
            self.map_stream = torch.cuda.Stream(fs.device)
            self.track_stream.wait_stream(current)
            self.map_stream.wait_stream(current)
        if not linearize_operation and fs.initialized:
            fs.warm_retrack_programs()
        self.thread = None
        if self.running:
            self.thread = threading.Thread(target=self._mapping_loop,
                                           name="ldso-mapping", daemon=True)
            self.thread.start()

    # ------------------------------------------------------------- tracking
    def add_active_frame(self, image, frame_id, exposure=1.0, timestamp=0.0):
        """The tracking side; tracked frames go to the mapping thread
        (deliverTrackedFrame, FullSystem.cc:160-177)."""
        if self.exc:
            raise self.exc
        fs = self.fs
        # an image already on the card was made on the caller's stream
        # (ImageFolderReader.get_image): hand it over like a pyramid
        made = (record_event(fs.device) if isinstance(image, torch.Tensor)
                and image.device.type == "cuda" else None)
        if self.linearize_operation or not fs.initialized:
            # bootstrap frames build mapping state: the mapping stream
            with self._map_lock, _on_stream(self.map_stream):
                use_on_current_stream(image, made, fs.device)
                shell = fs.add_active_frame(image, frame_id, exposure,
                                            timestamp)
                if not self.linearize_operation and fs.initialized:
                    fs.warm_retrack_programs()
            return shell
        with _on_stream(self.track_stream):
            use_on_current_stream(image, made, fs.device)
            if self._chain_dirty:
                # land the frames in flight on the (possibly bad) chain;
                # _drain rebuilds the chain from the host once empty
                self._drain(block=True)
                if fs.is_lost:
                    return None
            shell = FrameShell(id=frame_id, timestamp=timestamp,
                               exposure=exposure)
            shell.pose_valid = False        # until its result is consumed
            fs.all_frames.append(shell)
            pyr, packed, ref_shell = fs.track_chain_dispatch(shell, image)
            self.pending.append((shell, image, pyr, packed, ref_shell))
            self._drain(block=False)
        return shell

    def _redispatch_inflight(self):
        """Re-dispatch every frame not yet consumed against the current
        tracker ref and a chain rebuilt from the host, after a gate trip's
        host retrack: their results rode the same stale chain and would
        each trip the gate again. Tracking thread only."""
        fs = self.fs
        old = [(sh, img) for sh, img, _, _, _ in self.pending]
        self.pending.clear()
        fs.chain_reset()
        self._chain_dirty = False
        for sh, img in old:
            pyr, packed, ref_shell = fs.track_chain_dispatch(sh, img)
            self.pending.append((sh, img, pyr, packed, ref_shell))

    def _drain(self, block: bool):
        """Consume chain results in order: those whose copy home has landed,
        and (blocking) enough to keep at most CHAIN_DEPTH in flight; with
        block=True, all of them."""
        fs = self.fs
        while self.pending and not fs.is_lost:
            if (not block and len(self.pending) <= self.CHAIN_DEPTH
                    and not self.pending[0][3].is_ready()):
                return
            shell, image, pyr, packed, ref_shell = self.pending.popleft()
            with fs.timer.stage("pipe.consume"):
                consumed = fs.track_chain_consume(shell, packed, ref_shell)
            if not consumed:
                # gate tripped: host retry sweep against the CURRENT ref
                # (the reference also retracks against the newest keyframe,
                # FullSystem.cc:104-123)
                self.retrack_trips += 1
                with fs.timer.stage("pipe.retrack"):
                    ok = fs._track_new_coarse(
                        shell, image, commit_trace=False,
                        neighbors=(self._slast, self._sprelast))
                if not ok:
                    fs.is_lost = True
                    return
                # the flow and affine are now relative to the current ref
                ref_shell = fs._last_track_ref
                shell.pose_valid = True     # seen by the chain rebuild
                self._redispatch_inflight()
            shell.pose_valid = True
            self._sprelast, self._slast = self._slast, shell
            need_kf = fs._keyframe_decision(shell, ref=ref_shell)
            handoff = record_event(fs.device)
            with self.cond:
                while len(self.unmapped) >= self.max_queue and self.running:
                    with fs.timer.stage("pipe.backpressure"):
                        self.cond.wait(0.05)
                self.unmapped.append((shell, pyr, handoff))
                if need_kf:
                    # DSO: needNewKFAfter = shell->trackingRef->id
                    self.need_new_kf_after = max(self.need_new_kf_after,
                                                 ref_shell.id)
                self.cond.notify_all()
        if self._chain_dirty and not self.pending:
            fs.chain_reset()
            self._chain_dirty = False

    # -------------------------------------------------------------- mapping
    def _finish_kf(self):
        """Run a deferred keyframe finish. Mapping thread, under _map_lock."""
        fin = self._kf_finish
        if fin is None:
            return
        self._kf_finish = None
        with self.fs.timer.stage("pipe.map_kf_finish"):
            fin()

    def _mapping_loop(self):
        try:
            with _on_stream(self.map_stream):
                self._map_frames()
        except BaseException as e:  # noqa: BLE001 -- raised on the caller
            self.exc = e
            with self.cond:
                self.running = False
                self.cond.notify_all()

    def _map_frames(self):
        fs = self.fs
        while True:
            with self.cond:
                while not self.unmapped and self.running:
                    fin = self._kf_finish
                    if fin is not None and fin.ready():
                        break       # idle, and the keyframe's results are in
                    self.cond.wait(timeout=0.005 if fin is not None else 0.1)
                if not self.unmapped:
                    if self._kf_finish is not None:
                        item = None             # a finish-only iteration
                    elif not self.running:
                        return
                    else:
                        continue
                else:
                    item = self.unmapped.popleft()
                    if len(self.unmapped) > self.KETCHUP_THRESHOLD:
                        self.need_ketchup = True
                qlen = len(self.unmapped)
                self.cond.notify_all()
            with self._map_lock:
                if item is None:
                    self._finish_kf()
                    continue
                # a ready finish publishes the new tracking reference: run
                # it before mapping more frames, so tracking does not run on
                # a stale ref (the reference bounds that staleness with its
                # one-deep coarseTracker swap, FullSystem.cc:104-111)
                fin = self._kf_finish
                if fin is not None and fin.ready():
                    self._finish_kf()
                shell, pyr, handoff = item
                use_on_current_stream(pyr, handoff, fs.device)
                if fs.global_map.num_frames() <= 2:
                    # the first two tracked frames are keyframes, made
                    # synchronously: the gate itself reads the finish's
                    # keyframe count
                    self._finish_kf()
                    with fs.timer.stage("pipe.map_kf"):
                        fs.make_keyframe(shell, pyr)
                elif qlen > 0:
                    # frames waiting: mapping is behind
                    with fs.timer.stage("pipe.map_nonkf"):
                        fs.make_non_keyframe(shell, pyr)
                    if self.need_ketchup:
                        with self.cond:
                            if self.unmapped:
                                # skip one queued frame outright
                                # (FullSystem.cc:1845-1852)
                                self.unmapped.popleft()
                                self.cond.notify_all()
                else:
                    newest_id = (fs.window_frames[-1].id
                                 if fs.window_frames else -1)
                    if self.need_new_kf_after >= newest_id:
                        # the previous keyframe's finish must run before
                        # the next dispatch (window renumbering, kf ids)
                        self._finish_kf()
                        with fs.timer.stage("pipe.map_kf"):
                            self._kf_finish = fs.make_keyframe_dispatch(
                                shell, pyr)
                        self.need_ketchup = False
                    else:
                        with fs.timer.stage("pipe.map_nonkf"):
                            fs.make_non_keyframe(shell, pyr)

    def block_until_mapping_is_finished(self):
        """blockUntilMappingIsFinished (FullSystem.cc:384-409), then the
        shutdown pose graph."""
        fs = self.fs
        with _on_stream(self.track_stream):
            self._drain(block=True)
        with self.cond:
            self.running = False
            self.cond.notify_all()
        if self.thread is not None:
            self.thread.join(timeout=600)
            if self.thread.is_alive():
                raise RuntimeError("the mapping thread did not finish in 600 s")
        if self.exc:
            raise self.exc
        if self.map_stream is not None:
            current = torch.cuda.current_stream(fs.device)
            current.wait_stream(self.track_stream)
            current.wait_stream(self.map_stream)
        _final_pose_graph(fs)
