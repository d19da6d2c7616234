"""``kgct-torch-lint`` over the port, on the CPU.

- The JAX package's rule pins (``tests/test_lint_rules.py``) and lint-gate
  cases (``tests/test_lint_clean.py``) re-pointed at the port's
  ``analysis`` package (``torch_carry``: exact substitutions, carried cases
  named by their file). Left out: ``TestTraceSafety``,
  ``TestRecompileRisk`` and ``TestDonationSafety`` (11 cases): their
  snippets are JAX's (``jax.jit``, ``donate_argnums``); the port's KGCT001,
  KGCT003 and KGCT004 police the engine's captured decode programs
  (``engine/step_programs.py``) and are held below in torch's spelling.
  The two non-vacuity cases
  of ``test_lint_clean.py`` are re-aimed at the port's engine, async
  engine and API server here, under their carried names.
- Every registered rule visits the port's real structures: the shipped
  file it guards is clean, and one line of it changed the way the rule
  exists to catch is a finding.
- The torch-spelled rules (KGCT001, 002, 003, 004, 009, 012, 013, 018)
  each find a bad snippet in torch's spelling and pass its clean twin.
- The port package is clean with an empty baseline and no allowlist, under
  this linter and under the JAX package's.
"""

from __future__ import annotations

import ast
import textwrap
from pathlib import Path

import pytest

from kubernetes_gpu_cluster_tpu.analysis import run_lint as jax_run_lint
from kubernetes_gpu_cluster_tpu_torch.analysis import ALL_RULES, run_lint
from kubernetes_gpu_cluster_tpu_torch.analysis.core import (
    CTX_LOOP, CTX_WORKER, LintModule, PackageModel, get_module,
    iter_py_files)
from kubernetes_gpu_cluster_tpu_torch.analysis.rules import rules_by_code
from torch_carry import PORT, carry, expose

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / PORT

_RULE_FIXES = [
    ('root / "kubernetes_gpu_cluster_tpu" / "ops" / "quant.py",\n'
     '            root=root / "kubernetes_gpu_cluster_tpu")',
     f'root / "{PORT}" / "ops" / "quant.py",\n'
     f'            root=root / "{PORT}")'),
]
_CLEAN_FIXES = [
    ('PACKAGE = REPO / "kubernetes_gpu_cluster_tpu"\n',
     f'PACKAGE = REPO / "{PORT}"\n'),
    ("findings = run_lint([PACKAGE, BENCH], root=REPO)",
     "findings = run_lint([PACKAGE], root=REPO)"),
    ('kgct-lint = "', 'kgct-torch-lint = "'),
    ('driver["name"] == "kgct-lint"', 'driver["name"] == "kgct-torch-lint"'),
]
expose("test_lint_rules", carry("test_lint_rules", _RULE_FIXES), None,
       globals(), leave_out=("TestTraceSafety", "TestRecompileRisk",
                             "TestDonationSafety"))
expose("test_lint_clean", carry("test_lint_clean", _CLEAN_FIXES), None,
       globals(), leave_out=(
           "test_all_rules_actually_ran_against_real_structures",
           "test_concurrency_graph_resolves_real_seam_not_vacuous"))


def lint(code: str, rule_code: str, relpath: str = "engine/fake.py"):
    mod = LintModule(Path(relpath), source=textwrap.dedent(code))
    [rule] = rules_by_code([rule_code])
    return list(rule.check(mod))


# -- the two non-vacuity cases, re-aimed at the port --------------------------

def test_lint_clean__all_rules_actually_ran_against_real_structures():
    """The shared analyses resolve the port engine's real hot path, and the
    device_fetch windows resolve: the fetch helpers sit on the hot path but
    are reached only from inside a window, and the step's sanctioned syncs
    are found there."""
    mod = LintModule(PACKAGE / "engine" / "engine.py", root=REPO)
    hot = {f.name for f in mod.hot_path_functions}
    assert {"step", "_step", "_step_spec", "_dispatch_window",
            "_process_window"} <= hot
    unfetched = {f.name for f in mod.unfetched_hot_path_functions}
    assert {"_finish_fetch"} <= hot - unfetched
    assert {"_step", "_step_spec", "_step_spec_mixed", "_process_window",
            "_fetch_step", "_wait_step"} <= unfetched
    # Every step's one wait: the window's fetch in _step, the step
    # programs' event and fetch in _wait_step; no .cpu() is left.
    in_window = [
        node for fn in mod.unfetched_hot_path_functions
        for node in ast.walk(fn)
        if getattr(node, "attr", None) in ("cpu", "_finish_fetch",
                                           "synchronize")
        and mod.inside_phase_block(node, "device_fetch")]
    assert sorted(n.attr for n in in_window) == [
        "_finish_fetch", "_finish_fetch", "synchronize"]


def test_lint_clean__concurrency_graph_resolves_real_seam_not_vacuous():
    """The PackageModel over the port resolves the worker-op seam, the
    async->engine paths through it and the one cross-boundary lock."""
    mods = [get_module(p, root=REPO) for p in iter_py_files([PACKAGE])]
    pm = PackageModel(mods)
    assert any("serving/api_server.py" in rel for rel, _, _ in pm.seam_sites)
    assert {"export_held", "import_request"} <= set(pm.worker_op_targets)
    assert any("api_server" in caller for caller, _ in pm.async_engine_paths)
    ae = next(m for m in mods if m.relpath.replace("\\", "/").endswith(
        "serving/async_engine.py"))
    assert CTX_WORKER in pm.contexts_of(ae, "AsyncLLMEngine._worker")
    assert CTX_LOOP in pm.contexts_of(ae, "AsyncLLMEngine.generate")
    assert {CTX_LOOP, CTX_WORKER} <= pm.lock_contexts_of(ae, "_cv")
    empty = PackageModel([])
    assert not empty.seam_sites and not empty.async_engine_paths


# -- every rule reaches the port's real structures ----------------------------

_OLD_CHUNK_READ = '''                await self._begin_chunk()
                if self._done:
                    break
'''
_NEW_CHUNK_READ = '''                size_line = await self._readline("chunk-size line",
                                                 ClientPayloadError)
                size = int(size_line.split(b";")[0].strip(), 16)
                if size == 0:
                    self._done = True
                    break
                self._left = size
'''

# The draft runner's slot math; without its max-len guard below.
_FEED_SLOT = '''               max_len: int) -> int:
    """The draft-pool slot a feed at ``pos`` writes: the row's own page,
    or the scrap page past the draft horizon."""
    if pos >= max_len:
'''

# code -> (file of the port, its text, the same line(s) as the rule's bug)
MUTATIONS = {
    # The step key read on the host inside the captured window: a constant
    # of the graph, the same randomness every replay.
    "KGCT001": ("engine/engine.py",
                'keys = row_sample_keys(bufs["step_key"], p["seed"],',
                'keys = row_sample_keys(int(bufs["step_key"]), p["seed"],'),
    # The program keyed by the live row count instead of the bucket.
    "KGCT003": ("engine/engine.py",
                "B = batch.page_tables.shape[0]        # the scheduler's "
                "bucket",
                "B = len(batch.seqs)"),
    # The predecessor's tokens fetched from its program's outputs after the
    # successor's replay overwrote them.
    "KGCT004": ("engine/engine.py",
                'toks, lps, *tops = self._finish_fetch(inflight["fetch"])',
                "toks, lps, *tops = self._finish_fetch(\n"
                '                self._start_fetch(inflight["dev_out"]))'),
    # A step program's wait moved out of its device_fetch window.
    "KGCT002": ("engine/engine.py",
                '        done, fetch = pending\n'
                '        with self.obs.phases.phase("device_fetch"):\n',
                '        done, fetch = pending\n'
                '        done.synchronize()\n'
                '        with self.obs.phases.phase("device_fetch"):\n'),
    "KGCT005": ("engine/spec/draft_model.py", _FEED_SLOT,
                _FEED_SLOT.replace("max_len", "horizon")),
    "KGCT006": ("serving/async_engine.py",
                "            await asyncio.sleep(0)\n"
                "        if request_id in self._reserved:",
                "            time.sleep(0)\n"
                "        if request_id in self._reserved:"),
    "KGCT007": ("observability/__init__.py",
                "self.swap_latency.observe(duration_s, (direction,))",
                "self.swap_latency.observe(duration_s, (request_id,))"),
    "KGCT008": ("serving/async_engine.py",
                'logger.warning("worker op dropped: engine shut down")',
                'logger.warning(f"worker op dropped: {fn}")'),
    "KGCT009": ("models/llama.py",
                '_dot(attn_fn(q, k, v, layer).reshape(T, -1), lp, "wo")',
                '(attn_fn(q, k, v, layer).reshape(T, -1) @ lp["wo"])'),
    "KGCT010": ("engine/scheduler.py",
                "            host_pages = self.swapper.swap_out(",
                "            self._release(victim)\n"
                "            host_pages = self.swapper.swap_out("),
    "KGCT011": ("serving/router.py",
                "    def _pick(self, exclude", "    def _choose(self, exclude"),
    "KGCT012": ("observability/trace.py",
                "        rec = self.recorder\n",
                "        rec = self.recorder\n        print(kind)\n"),
    "KGCT013": ("engine/engine.py",
                "L, _, ps, kd = self.kv_cache.k.shape",
                "L, _, ps, kd = self.kv_cache.k.cpu().shape"),
    "KGCT014": ("engine/engine.py",
                '            "sampling": seq.params.to_state(),\n',
                '            "sampling": seq.params.to_state(),\n'
                '            "window": self._inflight,\n'),
    "KGCT015": ("engine/scheduler.py",
                "            self.swapper.notify_restored(seq)\n",
                "            self.swapper.notify_restored(seq)\n"
                "            self.qos.virtual_tokens[seq.tier] = 0.0\n"),
    "KGCT016": ("serving/api_server.py",
                "                await self.engine.run_in_worker(\n"
                "                    lambda eng: eng.import_request("
                "rid, ids, params, state))",
                "                self.engine.engine.import_request("
                "rid, ids, params, state)"),
    "KGCT017": ("engine/engine.py",
                "ctrl = self.scheduler.spec_controller\n        if ctrl",
                "ctrl = self.scheduler.spec_proposer.allocator\n        if ctrl"),
    "KGCT018": ("serving/api_server.py",
                "                verify_import_state(state)\n"
                "                await self.engine.run_in_worker(\n"
                "                    lambda eng: eng.import_request(",
                "                await self.engine.run_in_worker(\n"
                "                    lambda eng: eng.import_request("),
    "KGCT019": ("serving/http.py", _OLD_CHUNK_READ, _NEW_CHUNK_READ),
    "KGCT020": ("serving/api_server.py",
                "                verify_import_state(state)\n"
                "                await self.engine.run_in_worker(\n",
                "                verify_import_state(state)\n"
                "                self.engine.engine.scheduler.running.clear()\n"
                "                await self.engine.run_in_worker(\n"),
    "KGCT021": ("serving/multihost.py",
                "    def broadcast(self, adds, aborts) -> None:",
                "    async def broadcast(self, adds, aborts) -> None:"),
}


def test_every_registered_rule_has_a_real_structure_case():
    assert sorted(MUTATIONS) == sorted(r.code for r in ALL_RULES)
    assert len(ALL_RULES) == 21


@pytest.mark.parametrize("code", sorted(MUTATIONS))
def test_rule_reaches_the_ports_real_structure(code):
    rel, old, new = MUTATIONS[code]
    path = PACKAGE / rel
    src = path.read_text()
    assert src.count(old) == 1, f"{rel}: the {code} anchor no longer matches"
    [rule] = rules_by_code([code])
    shipped = LintModule(path, source=src, root=REPO)
    assert list(rule.check(shipped)) == []
    broken = LintModule(path, source=src.replace(old, new), root=REPO)
    found = list(rule.check(broken))
    assert found and all(f.rule == code for f in found), found


def test_capture_safety_reaches_the_mixed_body():
    """The mixed step's program body (``_mixed_body``, handed to the cache
    in its family dict) with the chunk's history length read on the host
    in the metadata it builds (``_mixed_meta``, which the spec×mixed body
    shares: one finding): a constant of the graph, every replay's chunk
    attending to the first one's history."""
    path = PACKAGE / "engine/engine.py"
    src = path.read_text()
    old = 'hist_len=bufs["hist_len"], page_tables=bufs["page_tables"],'
    new = ('hist_len=int(bufs["hist_len"]), '
           'page_tables=bufs["page_tables"],')
    assert src.count(old) == 1, "the mixed body's anchor no longer matches"
    [rule] = rules_by_code(["KGCT001"])
    assert list(rule.check(LintModule(path, source=src, root=REPO))) == []
    found = list(rule.check(LintModule(path, source=src.replace(old, new),
                                       root=REPO)))
    assert [f.rule for f in found] == ["KGCT001"]
    assert "_mixed_meta" in found[0].message


# (file, anchor, planted host read, the captured function named): the
# verify rows' step key, the spec×mixed chunk row's position, the draft
# dispatch's previous argmax and the draft reset chunk's history length.
_SPEC_HOST_READS = {
    "spec": ("engine/engine.py",
             'bufs["context_lens"], bufs["step_key"], bufs["seed"][rows],',
             'bufs["context_lens"], int(bufs["step_key"]), '
             'bufs["seed"][rows],', "_verify_rows"),
    "spec_mixed": ("engine/engine.py",
                   'bufs["positions"][idx] + 1, chunk)',
                   'bufs["positions"][idx].item() + 1, chunk)',
                   "_spec_mixed_body"),
    "draft_decode": ("engine/spec/draft_model.py",
                     'tokens = torch.where(step[1] != 0, step[0], '
                     'bufs["out_tok"])',
                     'tokens = torch.where(step[1] != 0, step[0], '
                     'bufs["out_tok"].cpu())', "_decode_body"),
    "draft_prefill": ("engine/spec/draft_model.py",
                      'self.kv_cache, bufs["page_table"][0], bufs["hist_len"])',
                      'self.kv_cache, bufs["page_table"][0], '
                      'int(bufs["hist_len"]))', "_prefill_body"),
}


@pytest.mark.parametrize("family", sorted(_SPEC_HOST_READS))
def test_capture_safety_reaches_the_spec_and_draft_bodies(family):
    """A host read planted in the spec, spec×mixed and draft bodies (the
    draft runner's registered in its engine's cache through
    ``add_families``): KGCT001 finds it in the captured function."""
    rel, old, new, where = _SPEC_HOST_READS[family]
    path = PACKAGE / rel
    src = path.read_text()
    assert src.count(old) == 1, f"{family}: the anchor no longer matches"
    [rule] = rules_by_code(["KGCT001"])
    assert list(rule.check(LintModule(path, source=src, root=REPO))) == []
    found = list(rule.check(LintModule(path, source=src.replace(old, new),
                                       root=REPO)))
    assert [f.rule for f in found] == ["KGCT001"], found
    assert where in found[0].message


# (file, anchor, the key built from a live count instead of the bucket)
_SPEC_KEYS = {
    "spec": ("engine/engine.py",
             "        key = self._step_program_key(batch)\n",
             '        key = ("spec", len(batch.seqs), batch.spec_S)\n'),
    "draft_decode": ("engine/spec/draft_model.py",
                     '        key = ("draft_decode", B)\n',
                     '        key = ("draft_decode", len(tables))\n'),
    "draft_prefill": ("engine/spec/draft_model.py",
                      '            key = ("draft_prefill", T, width)\n',
                      '            key = ("draft_prefill", len(row.pages), '
                      'width)\n'),
}


@pytest.mark.parametrize("family", sorted(_SPEC_KEYS))
def test_recompile_risk_reaches_the_spec_and_draft_keys(family):
    """A spec or draft program keyed by a live, unbucketed count: KGCT003
    finds it in the engine's and in the draft runner's dispatch."""
    rel, old, new = _SPEC_KEYS[family]
    path = PACKAGE / rel
    src = path.read_text()
    assert src.count(old) == 1, f"{family}: the anchor no longer matches"
    [rule] = rules_by_code(["KGCT003"])
    assert list(rule.check(LintModule(path, source=src, root=REPO))) == []
    found = list(rule.check(LintModule(path, source=src.replace(old, new),
                                       root=REPO)))
    assert found and all(f.rule == "KGCT003" for f in found), found


def test_donation_safety_reaches_the_draft_runner():
    """The draft runner's cache (its engine's, bound through
    ``add_families``) and its replaying methods resolve for KGCT004; the
    runner fetches each round right after its last replay, so the rule is
    silent on it, and fires when a round's outputs are handed out
    unfetched and read after a later replay (a reset chunk)."""
    path = PACKAGE / "engine/spec/draft_model.py"
    src = path.read_text()
    mod = LintModule(path, source=src, root=REPO)
    [cls] = [c for c in mod.classes if c.name == "DraftModelRunner"]
    assert mod.program_cache_attrs(cls) == {"_programs"}
    [rule] = rules_by_code(["KGCT004"])
    assert list(rule.check(mod)) == []
    old_ret = '        return self._fetch(bufs["outs"][:k])\n'
    new_ret = '        return {"drafts": bufs["outs"]}\n'
    old_use = ("        out = self._dispatch(forced, replay, positions, "
               "slots, context_lens,\n                             tables)\n")
    new_use = ("        held = self._dispatch(forced, replay, positions, "
               "slots, context_lens,\n                              tables)\n"
               "        self._reset_row(seqs[active[0]], "
               "self._rows[seqs[active[0]].request_id])\n"
               '        out = self._fetch(held["drafts"])\n')
    assert src.count(old_ret) == 1 and src.count(old_use) == 1
    broken = LintModule(path, source=src.replace(old_ret, new_ret).replace(
        old_use, new_use), root=REPO)
    found = list(rule.check(broken))
    assert [f.rule for f in found] == ["KGCT004"], found


# -- torch spellings -----------------------------------------------------------

@pytest.mark.parametrize("spelling", [
    "out.cpu()", "out.tolist()", "out.item()", "out.numpy()",
    "torch.cuda.synchronize()", "self._done.synchronize()", "self._sync()",
    "int(out[0])"])
def test_host_sync_torch_spellings(spelling):
    bad = lint(f"""
        class FooEngine:
            def _step(self):
                out = self._forward("decode", 1)
                return {spelling}
    """, "KGCT002")
    assert len(bad) == 1 and "device_fetch" in bad[0].message
    assert lint(f"""
        class FooEngine:
            def _step(self):
                out = self._forward("decode", 1)
                with ph("device_fetch"):
                    return {spelling}
    """, "KGCT002") == []


def test_host_sync_fetch_helper_inherits_the_window_only_inside_it():
    helper = """
            def _sync(self):
                torch.cuda.synchronize(self.device)
    """
    inside = lint("""
        class FooEngine:
            def _step(self):
                with ph("device_fetch"):
                    self._sync()
    """ + helper, "KGCT002")
    assert inside == []
    outside = lint("""
        class FooEngine:
            def _step(self):
                self._sync()
    """ + helper, "KGCT002")
    # the call, and the helper's body now reached outside the window
    assert {f.line for f in outside} == {4, 7}


@pytest.mark.parametrize("snippet", [
    'torch.matmul(x, lp["wq"])', 'torch.mm(x, lp["wk"])',
    'F.linear(x, lp["w_up"])', 'torch.einsum("td,do->to", x, lp["wv"])',
    'lp["w_down"].to(torch.bfloat16)', 'lp["w_gate"].float()'])
def test_quant_surface_torch_spellings(snippet):
    found = lint(f"""
        def mlp(x, lp):
            return {snippet}
    """, "KGCT009", relpath="models/fake.py")
    assert len(found) == 1
    assert lint("""
        def _dot(x, lp, name):
            return torch.matmul(x, lp[name].float())

        def mlp(x, lp):
            return _dot(x, lp, "wq") + torch.matmul(x, lp["router"])
    """, "KGCT009", relpath="models/fake.py") == []


@pytest.mark.parametrize("spelling", [
    "torch.cuda.synchronize()", "self.buf.cpu()", "self.buf.tolist()",
    "self._event.synchronize()"])
def test_trace_emit_torch_spellings(spelling):
    found = lint(f"""
        class RequestTracer:
            def emit(self, kind, request_id="", **args):
                {spelling}
                self._ring.append((kind, request_id, args))
    """, "KGCT012", relpath="observability/trace.py")
    assert len(found) == 1 and "O(append)" in found[0].message
    assert lint("""
        class RequestTracer:
            def emit(self, kind, request_id="", **args):
                self._ring.append((kind, request_id, args))

            def dump(self):
                return [e.cpu() for e in self._ring]
    """, "KGCT012", relpath="observability/trace.py") == []


@pytest.mark.parametrize("fetch", [
    "self.kv_cache.k[:, pages].cpu()", "kv.v.numpy()",
    'self.kv_cache.k.to("cpu")', 'kv.k.to(device=torch.device("cpu"))',
    "host.copy_(self.kv_cache.v[:, pages])"])
def test_kv_boundary_torch_spellings(fetch):
    found = lint(f"""
        class Engine:
            def leak(self, kv, pages, host):
                return {fetch}
    """, "KGCT013", relpath="serving/api_server.py")
    assert len(found) == 1 and "sanctioned" in found[0].message
    assert lint(f"""
        class KVPageIO:
            def export_pages(self, kv, pages, host):
                return {fetch}
    """, "KGCT013", relpath="engine/kv_cache.py") == []
    assert lint("""
        def fine(toks, self):
            return (toks.cpu(), self.kv_cache.k.to("cuda"),
                    self.kv_cache.k.shape, host.copy_(toks))
    """, "KGCT013", relpath="engine/engine.py") == []


_CAPTURED = """
    class FooEngine:
        def __init__(self):
            self._programs = StepPrograms(self._body, self._layout, dev, True)

        def _body(self, key, bufs):
            variant, B = key
            toks = bufs["tokens0"]
            if variant == "greedy" and toks.shape[0] == B and len(toks):
                toks = self._head(toks, B)
            {line}
            bufs["out"].copy_(toks)

        def _head(self, toks, n):
            return toks[:n]
"""


@pytest.mark.parametrize("line", [
    "toks.item()", "toks.cpu()", "toks.tolist()", "toks.numpy()",
    "torch.cuda.synchronize()", "self._done.synchronize()",
    "n = int(toks[0])", "b = bool(toks.any())", "x = float(toks.sum())",
    "if toks.sum() > 0: pass", "while toks.any(): pass",
    "assert toks.max() < 5", "y = 1 if toks[0] else 2",
    "z = torch.from_numpy(host).to(toks.device)"])
def test_capture_safety_torch_spellings(line):
    found = lint(_CAPTURED.format(line=line), "KGCT001")
    assert len(found) == 1 and "_body" in found[0].message, found
    # The same line in a method the program cache does not capture.
    assert lint(_CAPTURED.format(line="pass").replace(
        "            pass\n", "") + f"""
        def _step(self, toks):
            {line}
    """, "KGCT001") == []


def test_capture_safety_follows_the_bodys_tensor_calls():
    found = lint(_CAPTURED.format(line="pass").replace(
        "return toks[:n]", "return toks[:int(toks[0])]"), "KGCT001")
    assert len(found) == 1 and "_head" in found[0].message
    # ``n`` is bound to the key's B: static, silent.
    assert lint(_CAPTURED.format(line="pass").replace(
        "return toks[:n]", "return toks[:int(n)]"), "KGCT001") == []


@pytest.mark.parametrize("capture", [
    "torch.cuda.CUDAGraph()", "torch.cuda.graph(g)",
    "g.capture_begin(pool=p)", "torch.cuda.make_graphed_callables(f, x)"])
def test_recompile_risk_torch_captures(capture):
    outside = lint(f"""
        def timed(g, p, f, x):
            return {capture}
    """, "KGCT003")
    assert len(outside) == 1 and "StepPrograms" in outside[0].message
    in_loop = lint(f"""
        class StepPrograms:
            def _capture(self, g, p, f, x):
                for _ in range(3):
                    {capture}
    """, "KGCT003")
    assert len(in_loop) == 1 and "loop" in in_loop[0].message
    assert lint(f"""
        class StepPrograms:
            def _capture(self, g, p, f, x):
                return {capture}
    """, "KGCT003") == []
    assert lint(f"""
        def timed(g, p, f, x):
            return {capture}
    """, "KGCT003", relpath="tools/sweep.py") == []


def test_recompile_risk_program_key_from_len():
    engine = """
        class FooEngine:
            def __init__(self):
                self._programs = StepPrograms(self._body, self._layout,
                                              dev, True)

            def _dispatch(self, batch):
                B = {size}
                key = ("greedy", B)
                self._programs.buffers(key).upload({{}})
                self._programs.run(key)
    """
    bad = lint(engine.format(size="len(batch.seqs)"), "KGCT003")
    assert len(bad) == 1 and "len()" in bad[0].message
    for size in ("batch.page_tables.shape[0]",
                 "_bucket(len(batch.seqs), self.buckets)",
                 "next_power_of_2(len(batch.seqs))"):
        assert lint(engine.format(size=size), "KGCT003") == []


_REPLAYS = """
    class FooEngine:
        def __init__(self):
            self._programs = StepPrograms(self._body, self._layout, dev, True)

        def _dispatch(self, key, prev=None):
            bufs = self._programs.buffers(key)
            if prev is not None:
                bufs["tokens0"].copy_(prev[:, -1])
            self._programs.run(key)
            fetch = self._start_fetch(bufs["out"])
            return {{"dev_out": bufs["out"], "fetch": fetch}}

        def _advance(self, w):
            return self._dispatch(w["key"], prev=w["dev_out"])

        def _step(self, w):
            {before}
            nxt = self._advance(w)
            {after}
"""


@pytest.mark.parametrize("before,after", [
    ("pass", 'return w["dev_out"].cpu()'),
    ('out = w["dev_out"]', "return out[:, -1]"),
    ("pass", 'return self._finish(self._start_fetch(w["dev_out"]))')])
def test_donation_safety_replay_outputs(before, after):
    found = lint(_REPLAYS.format(before=before, after=after), "KGCT004")
    assert len(found) == 1 and "replay" in found[0].message, found


@pytest.mark.parametrize("before,after", [
    ("pass", 'return self._finish(w["fetch"])'),
    ('last = w["dev_out"][:, -1].clone()', "return last"),
    ("pass", 'w = nxt\n            return w["dev_out"]'),
    ('return w["dev_out"]', "pass")])
def test_donation_safety_copies_and_rebinds_are_safe(before, after):
    assert lint(_REPLAYS.format(before=before, after=after),
                "KGCT004") == []


def test_wire_integrity_torch_frombuffer():
    found = lint("""
        def decode(blob):
            return torch.frombuffer(blob, dtype=torch.bfloat16)
    """, "KGCT018", relpath="serving/fleet_cache.py")
    assert len(found) == 1 and "frombuffer" in found[0].message
    assert lint("""
        def decode(blob):
            return torch.frombuffer(blob, dtype=torch.bfloat16)
    """, "KGCT018", relpath="serving/handoff.py") == []


# -- the gate -------------------------------------------------------------------

def test_port_is_lint_clean_with_an_empty_baseline():
    findings = run_lint([PACKAGE], root=REPO)
    assert findings == [], "\n".join(f.format() for f in findings)


def test_jax_linter_reads_the_port_clean_too():
    findings = jax_run_lint([PACKAGE], root=REPO)
    assert findings == [], "\n".join(f.format() for f in findings)


def test_module_main_prints_zero_findings_of_eighteen_rules(capsys):
    """Named when the port had 18 rules; with the captured programs'
    KGCT001, 003 and 004 it has the JAX package's 21."""
    from kubernetes_gpu_cluster_tpu_torch.analysis.cli import main
    assert main([]) == 0
    assert "0 finding(s) (21 rule(s))" in capsys.readouterr().err
