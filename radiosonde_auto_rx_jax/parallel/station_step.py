"""Full sharded station step: the whole station dataflow on a (ch, t) mesh.

Round-2 sharding covered only IF-FIR + FSK demod (parallel/pipeline.py).
This module shards the COMPLETE per-block dataflow the production
``Station.process_capture`` runs (station/station.py):

    wideband captures [B, 2, T]
      → PFB channelize            (halo'd overlap-save over ``t``)
      → Welch PSD                 (per-shard partial sums, psum over ``t``)
      → detect scores             (half-rate prescreen bank, pmax over ``t``)
      → expert routing            (capacity-padded ``all_to_all`` over ``ch``)
      → per-type FSK demod        (each shard demods its experts' channels)

in two jitted programs.  ``analyze`` is data-independent; between the two
the HOST applies its task state (temporary blocks, manual tasks, active
decoders — reference auto_rx/auto_rx.py:304-537) to turn scores into the
expert assignment, exactly where the reference's scan-results loop sits.
``route_demod`` then moves detected channels to their type's expert shard
(the MoE dispatch pattern over radio channels; the reference's analogue
is one decoder subprocess per (SDR, type), auto_rx.py:101-128) and runs
each type's demod chain where its channels landed.

Expert set: EVERY CHAIN_TABLE type that demodulates on a 48 kHz channel
— 12 experts, including the fractional-resample chains (DFM 50 kHz, M10
48.08 kHz: the resampler is a static periodic-block matmul,
ops/resample.py, so it runs inside the expert's ``lax.switch`` branch)
and the iMet AFSK chain (IF lowpass → FM discriminator → Bell-202 FSK
on the audio, models/imet4.py — IMET1RS/IMET1AB share the same demod
program and are named host-side).  The expert list is padded internally
to a multiple of the ``ch`` mesh size (pad experts are never routed and
their switch branch emits zeros).  Only the wideband chains (WXR*,
MK2LMS, RS92-NGP — which need >48 kHz channels) keep the station's
host-batched ``decode_channels`` path.

SPMD note: expert ↔ shard assignment cannot be a Python-static branch
(one program runs on every shard), so each local expert slot selects its
demod via ``lax.switch`` over the type table indexed by
``axis_index('ch')`` — all collectives stay OUTSIDE the switch (a
collective inside data-dependent control flow would deadlock the mesh).
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from jax import shard_map

from radiosonde_auto_rx_jax.demod.fsk import (
    fsk_init_state, fsk_num_blocks_buffered, _fsk_demod_scan_buffered)
from radiosonde_auto_rx_jax.detect.prescreen import Prescreen
from radiosonde_auto_rx_jax.detect.psd import _welch
from radiosonde_auto_rx_jax.detect.scanner import LPIQ_BW, LPFM_BW
from radiosonde_auto_rx_jax.detect.templates import TEMPLATES
from radiosonde_auto_rx_jax.ops.channelizer import _channelize, pfb_prototype
from radiosonde_auto_rx_jax.ops.resample import rational_ratio, resample_planes
from radiosonde_auto_rx_jax.parallel.halo import halo_exchange_left
from radiosonde_auto_rx_jax.parallel.mesh import CH_AXIS, T_AXIS
from radiosonde_auto_rx_jax.parallel.routing import dispatch_to_experts

# Types demodulated on-device as experts: every CHAIN_TABLE entry whose
# demod runs on the 48 kHz channel (directly, via the static fractional
# resampler, or via the AFSK front-end; station/station.py CHAIN_TABLE)
EXPERT_TYPES = ("RS41", "RS92", "DFM", "M10", "M20", "LMS6",
                "IMET5", "MEISEI", "MRZ", "MTS01", "IMET4", "RD94RD41")

# detector template name -> expert type.  The M10 template nominates the
# M10 expert by default (the reference's frm_M10 falls back to M10,
# dft_detect.c:932-965); the confirmation pass resolves M10-vs-M20 and
# the iMet subtypes before routing, so these defaults only matter for
# margin-threshold-only routing.  Templates absent here (wideband
# chains) fall back to the host path.
TEMPLATE_TO_EXPERT = {t: t for t in EXPERT_TYPES
                      if t not in ("M20", "IMET4")}
TEMPLATE_TO_EXPERT["IMETafsk"] = "IMET4"


class ShardedStationStep:
    """The station's per-block device dataflow, sharded over (ch, t).

    ``analyze(wide)``: wide [B, 2, T] f32 planes (sharded P(ch, -, t))
        -> (channels [C, 2, Tc] (ch, -, t), psd [B, nfft] (ch),
            ratios [C, K_templates] (ch))
    ``route_demod(channels, expert_ids)``: expert_ids [C] int32 (-1 =
        not routed) -> dict with per-expert soft/bits/ebno plus the
        routed global channel ids and slot masks.
    """

    def __init__(self, mesh, n_chan: int = 50, fs_ch: int = 48000,
                 capacity: int = 4, nfft: int = 2048,
                 frame_halo: int = 26400, conf_capacity: int = 2):
        from radiosonde_auto_rx_jax.station.station import (CHAIN_TABLE,
                                                            _demod_cfg)
        self.mesh = mesh
        self.n_chan = int(n_chan)
        self.fs_ch = int(fs_ch)
        self.capacity = int(capacity)
        self.nfft = int(nfft)
        self.n_sh = mesh.shape[CH_AXIS]
        self.n_t = mesh.shape[T_AXIS]
        # pad the expert axis up to a multiple of the ch mesh size; pad
        # experts are never routed and their switch branch emits zeros
        self.n_exp = len(EXPERT_TYPES)
        self.n_exp_pad = -(-self.n_exp // self.n_sh) * self.n_sh
        self.e_local = self.n_exp_pad // self.n_sh
        self.taps = jnp.asarray(pfb_prototype(self.n_chan))
        self.pfb_p = int(self.taps.shape[0]) // self.n_chan
        self.prescreen = Prescreen(self.fs_ch, TEMPLATES, LPIQ_BW, LPFM_BW)
        # full-rate confirmation machinery (classes/banks/conditioning);
        # its own prescreen is disabled — analyze() already screens
        self.conf_cap = int(conf_capacity)
        from radiosonde_auto_rx_jax.detect.scanner import SondeDetector
        self.detector = SondeDetector(self.fs_ch, prescreen=False)
        # template index (prescreen.spec_order) -> expert index or -1
        self.template_expert = np.array(
            [EXPERT_TYPES.index(TEMPLATE_TO_EXPERT[s.name])
             if s.name in TEMPLATE_TO_EXPERT else -1
             for s in self.prescreen.spec_order], np.int32)
        self.expert_cfgs = []
        self.expert_chain = []        # per-expert (resample_to, afsk)
        halos = []
        for name in EXPERT_TYPES:
            chain = CHAIN_TABLE[name]
            rs_to = chain.get("resample_to")
            afsk = bool(chain.get("afsk"))
            if afsk:
                from radiosonde_auto_rx_jax.models.imet4 import \
                    afsk_demod_config
                cfg = afsk_demod_config(self.fs_ch)
                rs_to = None
            else:
                cfg = _demod_cfg(rs_to or self.fs_ch, chain["rs"],
                                 chain.get("est", 10000),
                                 chain.get("mask", 0))
            self.expert_cfgs.append(cfg)
            self.expert_chain.append((rs_to, afsk))
            # per-expert demod warmup in CHANNEL samples: nmem + scan
            # slack at the effective rate, mapped back through the
            # resampler (plus its taps-long transient) / AFSK FIRs
            h = cfg.nmem + 8 * cfg.ts
            if rs_to:
                l_up, m_down = rational_ratio(self.fs_ch, rs_to)
                h = -(-h * m_down // l_up) + 16
            if afsk:
                h += 2 * 97           # IF + audio lowpass transients
            halos.append(h)
        # demod halo = scan warmup (nmem + buffered-scan slack) plus a
        # frame-length margin: a frame straddling a t-seam is fully
        # demodulated by the shard owning its tail (frames longer than
        # ``frame_halo`` samples — 0.55 s default, the RS41 frame — lose
        # seam crossings, the same loss the reference takes at any
        # decoder restart).  Each t-shard must hold >= halo_max samples.
        # With a single t-shard there are no seams: the halo would be
        # pure zero-padding (~39k samples, +80% demod work at 1 s
        # blocks) and is skipped entirely.
        self.halo_max = (max(halos) + int(frame_halo)) if self.n_t > 1 \
            else 0
        # detection halo: longest full-rate template + both FIR stages
        lmax = max(int(self.fs_ch / s.sps * len(s.header))
                   for s in self.prescreen.spec_order)
        self.det_halo = lmax + 4 * 97

    # ------------------------------------------------------------------ #

    def sharding(self, spec):
        return NamedSharding(self.mesh, spec)

    def _bits_len(self, t_local: int):
        """Per-expert (soft/bits length, n_blocks) for a t-shard of
        ``t_local`` channel samples (static table).  Resampled experts
        count blocks at their effective rate."""
        out = []
        for cfg, (rs_to, _) in zip(self.expert_cfgs, self.expert_chain):
            t_eff = t_local + self.halo_max
            if rs_to:
                l_up, m_down = rational_ratio(self.fs_ch, rs_to)
                t_eff = (t_eff - 16) * l_up // m_down
            nb = fsk_num_blocks_buffered(cfg, t_eff)
            out.append((nb * cfg.nsym * cfg.bits_per_symbol, nb))
        return out

    # ------------------------------------------------------------------ #

    @partial(jax.jit, static_argnames=("self", "screen"))
    def analyze(self, wide, screen: bool = True):
        """Channelize + PSD (+ optional all-channel detection scores),
        sharded (ch, t).

        ``screen=True`` additionally runs the half-rate prescreen bank
        over EVERY channel (scan-less operation / expert_assignment
        demos).  The production station passes ``screen=False``: its
        candidates come from the PSD scan peaks (like the reference's
        rtl_power -> detect_sonde flow, autorx/scan.py:948-1097) and go
        straight to the full-rate ``confirm`` pass — screening all
        ~500 channels costs more than confirming the <= max_peaks scan
        candidates exactly."""
        N = self.n_chan
        Pp = self.pfb_p
        nfft = self.nfft
        n_t = self.n_t
        prescreen = self.prescreen
        det_halo = self.det_halo
        single = self.mesh.size == 1

        def body(wl):
            B_l, _, T_l = wl.shape
            assert T_l % N == 0, "t-shard must be a multiple of n_chan"
            # one cast pass up front: channelizer and Welch each re-read
            # the full wideband block in the branch dtype
            from radiosonde_auto_rx_jax.ops.channelizer import \
                _branch_dtype
            wl = wl.astype(_branch_dtype())
            if n_t == 1:
                # no t-seams: _channelize's own zero history equals the
                # halo'd form exactly — skip the halo concat + trim
                # copies (~290 MB/step at bench geometry)
                ch = jax.vmap(lambda w: _channelize(w, self.taps, N))(wl)
            else:
                # --- channelize with (P-1)*N left halo: output columns
                # are bit-identical to the unsharded _channelize of the
                # full stream (shard 0's zero halo = the unsharded pad)
                halo = (Pp - 1) * N
                wx = halo_exchange_left(
                    wl.reshape(B_l * 2, T_l), halo, T_AXIS
                ).reshape(B_l, 2, T_l + halo)
                ch = jax.vmap(
                    lambda w: _channelize(w, self.taps, N)
                )(wx)[..., Pp - 1:]
            C_l = B_l * N
            chf = ch.reshape(C_l, 2, T_l // N)
            # --- Welch PSD: local segment sums, psum over t (sparse
            # hop: one nfft window per 4*nfft — see station.scan)
            psd = _welch(wl, nfft, hop=4 * nfft)
            if not single:
                # unconditional collective: also establishes
                # t-replication for the out_specs check when n_t == 1
                psd = jax.lax.psum(psd, T_AXIS) / n_t
            if not screen:
                return chf, psd
            # --- detection scores on every channel (half-rate prescreen
            # bank); template-length halo so headers straddling a t-seam
            # are still seen; max over t shards
            dc = jnp.mean(chf, axis=-1, keepdims=True) * 0.98
            if single:
                ratios = prescreen.template_ratios(chf - dc)
            elif n_t == 1:
                # no t-seams: the halo would be pure zero-padding (same
                # reasoning as the channelizer fast path above); the
                # trivial pmax still establishes t-replication for the
                # out_specs check
                ratios = prescreen.template_ratios(chf - dc)
                ratios = jax.lax.pmax(ratios, T_AXIS)
            else:
                chx = halo_exchange_left(
                    (chf - dc).reshape(C_l * 2, T_l // N), det_halo,
                    T_AXIS).reshape(C_l, 2, -1)
                ratios = prescreen.template_ratios(chx)
                ratios = jax.lax.pmax(ratios, T_AXIS)
            return chf, psd, ratios

        if single:
            # 1x1 mesh: every collective is a no-op — run the identical
            # body as a plain jit
            out = body(wide)
            return out if screen else (out[0], out[1], None)
        out_specs = (P(CH_AXIS, None, T_AXIS), P(CH_AXIS, None)) + \
            ((P(CH_AXIS, None),) if screen else ())
        out = shard_map(
            body, mesh=self.mesh,
            in_specs=(P(CH_AXIS, None, T_AXIS),),
            out_specs=out_specs,
        )(wide)
        return out if screen else (out[0], out[1], None)

    # ------------------------------------------------------------------ #

    def expert_assignment(self, ratios, margin: float = 1.0):
        """Host policy: per-channel expert id from template ratios.

        ratios: [C, K] (host numpy).  Returns (expert_ids [C] int32 with
        -1 = no expert, best_template [C] int32).

        APPROXIMATE fallback only: the ratios are half-rate prescreen
        scores, so near ``margin`` a channel can clear the threshold yet
        fail the exact full-rate pass (or the reverse), and lookalikes
        (M20-vs-M10, iMet subtypes, M20 idle firing the WXR template)
        are undisambiguated.  The production station instead routes the
        decisions of ``confirm``+``decide_confirmed`` (station/station.py
        _process_captures_sharded), which equal the single-device
        two-phase detector; tests/test_station_step.py demonstrates a
        channel this threshold-only policy would misroute."""
        r = np.asarray(ratios)
        best = r.argmax(axis=1)
        ok = r.max(axis=1) >= margin
        exp = np.where(ok, self.template_expert[best], -1).astype(np.int32)
        return exp, best.astype(np.int32)

    # ------------------------------------------------------------------ #

    @property
    def n_conf_slots(self) -> int:
        return self.n_sh * self.conf_cap

    @partial(jax.jit, static_argnames=("self",))
    def confirm(self, channels, slot_cids):
        """Full-rate confirmation pass on candidate channels, sharded.

        The prescreen ratios from ``analyze`` are approximate half-rate
        scores; type decisions need the exact 4-stream full-rate pass
        with header re-read and M10/M20 / iMet disambiguation (reference
        scan/dft_detect.c:866-965,1542-1607).  This runs that pass under
        the mesh: each candidate's full channel stream is assembled with
        one psum over ``ch`` + all_gather over ``t`` (a few slots ×
        stream length — trivial bytes), then each ch-shard conditions
        and correlates its ``conf_cap`` slots, so the expensive stage
        splits n_sh ways exactly like the host two-phase detector's
        survivor batch.

        channels: [C, 2, Tc] (ch, -, t); slot_cids: [n_conf_slots] int32
        GLOBAL channel ids (-1 pad), replicated.  Returns dict with
        per-class peak stats (val/ipk/dc/xm, each [n_slots, K_cls]) and
        the conditioned FM streams [n_classes, n_slots, T] for the host
        decision loop (``decide_confirmed``).
        """
        det = self.detector
        n_sh, cap = self.n_sh, self.conf_cap
        S = n_sh * cap
        single = self.mesh.size == 1
        classes = [(bank, tuple(int(v) for v in lens))
                   for _, _, _, bank, lens in det.classes]

        def body(xl, sc):
            from radiosonde_auto_rx_jax.detect.correlator import \
                _correlate_peaks
            C_l, _, T_l = xl.shape
            me = 0 if single else jax.lax.axis_index(CH_AXIS)
            own = (sc // C_l) == me                       # [S]
            rows = jnp.where(own, sc % C_l, 0)
            sel = jnp.where(own[:, None, None], xl[rows], 0.0)
            if single:
                mine = sel                                # [S, 2, T]
            else:
                sel = jax.lax.psum(sel, CH_AXIS)          # [S, 2, T_l]
                full = jax.lax.all_gather(sel, T_AXIS, axis=2,
                                          tiled=True)
                mine = jax.lax.dynamic_slice_in_dim(full, me * cap,
                                                    cap, 0)
            # same DC block as SondeDetector.detect's entry
            mine = mine - jnp.mean(mine, axis=-1, keepdims=True) * 0.98
            streams = det._condition(mine)                # per class [cap,T]
            peaks = []
            for fm, (bank, lens_t) in zip(streams, classes):
                val, ipk, dc, xm = _correlate_peaks(
                    fm, bank.astype(fm.dtype), lens_t)
                peaks.append((val, ipk, dc, xm))
            st = jnp.stack([s.astype(jnp.float32) for s in streams])
            flat = (st,) + tuple(v for p in peaks for v in p)
            if single:
                return flat
            # every t-shard computed identical values from the gathered
            # full streams; the rep checker cannot infer that from
            # all_gather, so establish t-replication explicitly (pmax of
            # equal values — a few slots' worth of traffic)
            return tuple(jax.lax.pmax(v, T_AXIS) for v in flat)

        n_cls = len(det.classes)
        if single:
            # 1x1 mesh: collective-free body under plain jit
            res = body(channels, slot_cids)
        else:
            # per class: val/ipk/dc are [cap, K]; xm is [cap]
            out_specs = ((P(None, CH_AXIS, None),) +
                         (P(CH_AXIS, None), P(CH_AXIS, None),
                          P(CH_AXIS, None), P(CH_AXIS)) * n_cls)
            res = shard_map(
                body, mesh=self.mesh,
                in_specs=(P(CH_AXIS, None, T_AXIS), P()),
                out_specs=out_specs,
            )(channels, slot_cids)
        streams = res[0]
        peaks = [tuple(res[1 + 4 * i + j] for j in range(4))
                 for i in range(n_cls)]
        return dict(streams=streams, peaks=peaks)

    def decide_confirmed(self, conf, slot_cids, max_det: int = 1):
        """Host decision loop over ``confirm`` outputs: identical logic
        (threshold, headcmp, M10/M20 + iMet disambiguation, score sort)
        to the single-device ``SondeDetector._detect_full``.

        Returns {global channel id: [Detection, ...]} for real slots."""
        from radiosonde_auto_rx_jax.detect.correlator import \
            decide_from_peaks
        from radiosonde_auto_rx_jax.ops.fm import FM_GAIN
        det = self.detector
        slot_cids = np.asarray(slot_cids)
        S = self.n_conf_slots
        merged = [[] for _ in range(S)]
        streams = conf["streams"]
        # headcmp + subtype disambiguation fetch the same conditioned
        # stream up to 3x per candidate; each uncached np.asarray is a
        # full device->host row transfer (same memoization as
        # correlator.detect_types)
        _cache = {}

        def _chan(ci, c):
            key = (ci, int(c))
            if key not in _cache:
                _cache[key] = np.asarray(streams[ci, c])
            return _cache[key]

        for ci, ((_, _, cls_specs, _, lens), pk) in enumerate(
                zip(det.classes, conf["peaks"])):
            val, ipk, dc, xm = (np.asarray(v) for v in pk)
            dets = decide_from_peaks(
                val, ipk, dc, xm, cls_specs, np.asarray(lens),
                chan=lambda c, ci=ci: _chan(ci, c),
                fm_gain_hz=self.fs_ch / (2.0 * FM_GAIN), max_det=0,
                fs=self.fs_ch, wideband=self.fs_ch > 50000)
            for s in range(S):
                merged[s].extend(dets[s])
        out = {}
        for s in range(S):
            cid = int(slot_cids[s])
            if cid < 0:
                continue
            merged[s].sort(key=lambda d: d.score, reverse=True)
            out[cid] = merged[s][:max_det] if max_det else merged[s]
        return out

    # ------------------------------------------------------------------ #

    @partial(jax.jit, static_argnames=("self",))
    def route_demod(self, channels, expert_ids):
        """All-to-all expert routing + per-type demod, sharded (ch, t).

        channels: [C, 2, Tc] (ch, -, t); expert_ids: [C] int32 (ch).
        Returns dict(soft [E, S, L], bits, ebno [E, S], ids [E, S],
        mask [E, S]) with E = len(EXPERT_TYPES), S = n_sh * capacity,
        soft/bits zero-padded to the longest expert's output and sliced
        per-type via ``bits_lens()`` on the host.
        """
        n_sh, n_t = self.n_sh, self.n_t
        e_local, cap = self.e_local, self.capacity
        n_exp, n_exp_pad = self.n_exp, self.n_exp_pad
        cfgs = self.expert_cfgs
        chains = self.expert_chain
        fs_ch = self.fs_ch
        halo_max = self.halo_max

        def body(xl, el):
            C_l, _, T_l = xl.shape
            assert T_l >= halo_max, (
                f"t-shard holds {T_l} channel samples < demod halo "
                f"{halo_max}; use fewer/longer time shards or a smaller "
                f"frame_halo")
            lens = self._bits_len(T_l)
            out_max = max(v for v, _ in lens)
            # global channel ids of this shard's rows
            cid = jax.lax.axis_index(CH_AXIS) * C_l + jnp.arange(C_l)
            recv, recv_m, recv_i, dropped = dispatch_to_experts(
                xl, el, n_exp_pad, cap, n_sh, channel_ids=cid)
            S_tot = n_sh * cap
            # demod halo (one exchange OUTSIDE the expert switch — a
            # collective inside lax.switch would deadlock the mesh);
            # no-op on a single t-shard (halo_max == 0)
            if halo_max:
                flat = recv.reshape(e_local * S_tot * 2, T_l)
                flat = halo_exchange_left(flat, halo_max, T_AXIS)
                xh = flat.reshape(e_local, S_tot, 2, T_l + halo_max)
            else:
                xh = recv

            sid = jax.lax.axis_index(CH_AXIS)
            soft_o, bits_o, ebno_o = [], [], []
            fsum_o, fcnt_o = [], []
            for slot in range(e_local):
                # this slot's expert id = sid * e_local + slot: select
                # the demod program at runtime via switch over types
                def branch(eidx):
                    if eidx >= n_exp:       # mesh-divisibility pad slot
                        def run_pad(xe):
                            # zeros derived from the (varying) input so
                            # the switch branches' output types match;
                            # ebno cast to f32 (channel planes may be
                            # bf16, real branches emit f32 ebno)
                            z = jnp.zeros((S_tot, out_max), jnp.float32) \
                                + 0.0 * xe[:, 0, :1].astype(jnp.float32)
                            zs = 0.0 * xe[:, 0, 0].astype(jnp.float32)
                            return z, z, zs, zs, zs
                        return run_pad
                    cfg = cfgs[eidx]
                    blen, nb = lens[eidx]
                    rs_to, afsk = chains[eidx]

                    def run(xe):
                        if nb == 0:
                            z = jnp.zeros((S_tot, out_max), jnp.float32) \
                                + 0.0 * xe[:, 0, :1].astype(jnp.float32)
                            zs = 0.0 * xe[:, 0, 0].astype(jnp.float32)
                            return z, z, zs, zs, zs
                        if rs_to:
                            # static periodic-block matmul resampler
                            # (the tsrc analogue, ops/resample.py)
                            xe = resample_planes(xe, fs_ch, rs_to)
                        if afsk:
                            # Bell-202: IF lowpass -> FM discriminator
                            # -> audio lowpass, then FSK on the tones
                            from radiosonde_auto_rx_jax.models.imet4 \
                                import afsk_fm_audio
                            audio = afsk_fm_audio(xe, fs_ch)
                            xe = jnp.stack(
                                [audio, jnp.zeros_like(audio)], axis=1)
                        state = fsk_init_state(cfg, S_tot)
                        state = jax.tree.map(
                            lambda a: jax.lax.pcast(
                                a, (CH_AXIS, T_AXIS), to="varying"),
                            state)
                        _, outs = _fsk_demod_scan_buffered(
                            cfg, xe, state, nb)
                        soft = jnp.transpose(outs["soft"], (1, 0, 2)
                                             ).reshape(S_tot, -1)
                        bits = jnp.transpose(outs["bits"], (1, 0, 2)
                                             ).reshape(S_tot, -1)
                        ebno = outs["ebno_db"].max(axis=0)
                        # carrier-offset residual: tone-mean of the
                        # demod's f_est over locked blocks (the drift
                        # signal; station._freq_residuals host analogue)
                        if afsk:
                            fsum = jnp.zeros_like(ebno)
                            fcnt = jnp.zeros_like(ebno)
                        else:
                            fe = outs["f_est"].mean(axis=-1)   # [nb, S]
                            eb = outs["ebno_db"]               # [nb, S]
                            # locked blocks only: within 10 dB of the
                            # slot's best block (prunes the noise tail
                            # of bursty transmissions) and above 3 dB
                            thr = jnp.maximum(3.0, eb.max(0) - 10.0)
                            good = (eb > thr[None, :]
                                    ).astype(jnp.float32)
                            fsum = (fe * good).sum(0)
                            fcnt = good.sum(0)
                        pad = out_max - soft.shape[1]
                        soft = jnp.pad(soft, ((0, 0), (0, pad)))
                        bits = jnp.pad(bits.astype(jnp.float32),
                                       ((0, 0), (0, pad)))
                        return soft, bits, ebno, fsum, fcnt
                    return run

                branches = [branch(s * e_local + slot)
                            for s in range(n_sh)]
                s_k, b_k, e_k, fs_k, fc_k = jax.lax.switch(sid, branches,
                                                           xh[slot])
                soft_o.append(s_k)
                bits_o.append(b_k)
                ebno_o.append(e_k)
                fsum_o.append(fs_k)
                fcnt_o.append(fc_k)
            # best block Eb/N0 across the time shards (unconditional:
            # establishes t-replication for the out_specs check)
            ebno = jax.lax.pmax(jnp.stack(ebno_o), T_AXIS)
            # residuals: locked-count-weighted mean across the t-shards
            # (a shard with no locked blocks contributes nothing — a
            # plain shard-mean would dilute bursty sondes toward zero)
            # NOTE: each shard thresholds "locked" against its LOCAL
            # best block (a collective inside the expert switch would
            # deadlock the mesh), so on n_t>1 meshes a signal-free
            # shard can contribute noise blocks.  n_t=1 is the
            # production default (COMPONENTS.md) and the host consumer
            # ignores the residual when fcnt is 0.
            fsum = jax.lax.psum(jnp.stack(fsum_o), T_AXIS)
            fcnt = jax.lax.psum(jnp.stack(fcnt_o), T_AXIS)
            fres = fsum / jnp.maximum(fcnt, 1.0)
            return (jnp.stack(soft_o), jnp.stack(bits_o),
                    ebno, fres, fcnt, recv_i, recv_m,
                    dropped.sum()[None])

        soft, bits, ebno, fres, fcnt, ids, mask, dropped = shard_map(
            body, mesh=self.mesh,
            in_specs=(P(CH_AXIS, None, T_AXIS), P(CH_AXIS)),
            out_specs=(P(CH_AXIS, None, T_AXIS), P(CH_AXIS, None, T_AXIS),
                       P(CH_AXIS, None), P(CH_AXIS, None),
                       P(CH_AXIS, None), P(CH_AXIS, None),
                       P(CH_AXIS, None), P(CH_AXIS)),
        )(channels, expert_ids)
        # drop the mesh-divisibility pad experts (always-masked rows)
        return dict(soft=soft[:self.n_exp], bits=bits[:self.n_exp],
                    ebno=ebno[:self.n_exp], fres=fres[:self.n_exp],
                    fcnt=fcnt[:self.n_exp],
                    ids=ids[:self.n_exp], mask=mask[:self.n_exp],
                    dropped=dropped)

    # ------------------------------------------------------------------ #
    # fused steady-state step (round-4 verdict #6): in the overwhelmingly
    # common block — task state unchanged, no new candidates — the whole
    # device cycle is ONE program: channelize + PSD + recentered
    # extraction of the forced rows + per-type demod of the active
    # channels.  The host applies its scan/task policy AFTER dispatch;
    # blocks where the policy disagrees with the speculation fall back
    # to the split confirm/route path per channel (station/station.py
    # _collect_sharded).  The jit key includes the static ``plan``
    # (type, padded-count) tuple — active sets change rarely, so the
    # compile cache covers operation after the first appearance of each
    # type mix.

    def _chain_for(self, name: str):
        """(cfg, resample_to, afsk) demod chain for a type — identical
        construction to Station.decode_channels."""
        cache = getattr(self, "_chain_cache", None)
        if cache is None:
            cache = self._chain_cache = {}
        if name not in cache:
            from radiosonde_auto_rx_jax.station.station import (
                CHAIN_TABLE, _demod_cfg)
            chain = CHAIN_TABLE[name]
            rs_to = chain.get("resample_to")
            afsk = bool(chain.get("afsk"))
            if afsk:
                from radiosonde_auto_rx_jax.models.imet4 import \
                    afsk_demod_config
                cfg = afsk_demod_config(self.fs_ch)
                rs_to = None
            else:
                cfg = _demod_cfg(rs_to or self.fs_ch, chain["rs"],
                                 chain.get("est", 10000),
                                 chain.get("mask", 0))
            cache[name] = (cfg, rs_to, afsk)
        return cache[name]

    @partial(jax.jit, static_argnames=("self", "plan", "scan"))
    def steady_step(self, wide, idx, blk, rows, ph_m, ph_r, plan,
                    scan: bool = True):
        """One fused program: analyze + forced-row recentering +
        per-type demod of the predicted active channels.

        wide: [B, 2, T]; idx: [K] global channel ids concatenated per
        plan entry (pad entries repeat a valid id and are dropped on
        the host); blk/rows/ph_m/ph_r: recentering slots (shape-[0]
        arrays when nothing is off-grid); plan: static tuple of
        (type_name, count).  ``scan=False`` skips the Welch PSD (the
        station scans 1-in-``scan_every`` blocks while decoding —
        strictly better than the reference, whose single-SDR stations
        cannot scan at all while a decoder holds the SDR) and returns
        ``psd=None``.  Returns (chf, psd, {type: (soft, bits,
        stats)})."""
        if scan:
            chf, psd, _ = self.analyze(wide, screen=False)
        else:
            assert self.mesh.size == 1, "no-scan steady is 1-device-only"
            from radiosonde_auto_rx_jax.ops.channelizer import \
                _branch_dtype
            wl = wide.astype(_branch_dtype())
            ch = jax.vmap(lambda w: _channelize(w, self.taps,
                                                self.n_chan))(wl)
            B_l = ch.shape[0]
            chf = ch.reshape(B_l * self.n_chan, 2, -1)
            psd = None
        if rows.shape[0]:
            from radiosonde_auto_rx_jax.ops.channelizer import _extract
            xs = wide[blk]
            ext = _extract(xs, self.taps, ph_m, ph_r, self.n_chan)
            chf = chf.at[rows].set(ext.astype(chf.dtype), mode="drop")
        outs = {}
        off = 0
        for name, n in plan:
            rows_t = idx[off:off + n]
            off += n
            cfg, rs_to, afsk = self._chain_for(name)
            x = chf[rows_t]
            if rs_to:
                x = resample_planes(x, self.fs_ch, rs_to)
            if afsk:
                from radiosonde_auto_rx_jax.models.imet4 import \
                    afsk_fm_audio
                audio = afsk_fm_audio(x, self.fs_ch)
                x = jnp.stack([audio, jnp.zeros_like(audio)], axis=1)
            from radiosonde_auto_rx_jax.demod.fsk import fsk_demod_stream
            soft, bits, stats, _ = fsk_demod_stream(cfg, x,
                                                    buffered=True)
            outs[name] = (soft, bits, stats)
        return chf, psd, outs

    def bits_lens(self, t_total: int):
        """Host helper: per-expert valid soft/bits length for a GLOBAL
        channel-sample count ``t_total`` (the [E, S, L] outputs
        concatenate ``n_t`` t-shards of padded slices; each shard's
        valid prefix is ``_bits_len(t_total // n_t)``)."""
        return self._bits_len(t_total // self.n_t)

    def slot_bits(self, res, expert: int, slot: int, t_total: int):
        """Host helper: assemble one routed slot's (bits, soft) from a
        ``route_demod`` result by concatenating each t-shard's valid
        prefix.  bits return as uint8, soft as float32."""
        blen, _ = self.bits_lens(t_total)[expert]
        bits = np.asarray(res["bits"][expert, slot])
        soft = np.asarray(res["soft"][expert, slot])
        seg = bits.shape[0] // self.n_t
        take = np.concatenate([np.arange(k * seg, k * seg + blen)
                               for k in range(self.n_t)])
        return bits[take].astype(np.uint8), soft[take].astype(np.float32)
