"""iMet-1/4 frame codec (Bell-202 AFSK 1200 Bd, 8N1, CRC16-CCITT/1D0F).

Frame structure per the reference decoder (reference imet/imet4iq.c):
8N1 byte framing, LSB-first, sync = 10 one-bits (:845-893); packet walk
over SOH=0x01 packets: GPS (0x02) / eGPS (0x05) with float32 lat/lon and
alt-5000 (:1035-1125), PTU (0x01) / ePTU (0x04) with P/T/U/battery
(:947-1020), XDATA (0x03) aux chain (:1133-1230); CRC16 0x1021 init
0x1D0F (:911-928); JSON gated on GPS+PTU valid in one frame (:1278-1305).

The AFSK demodulation itself reuses the batched FSK engine on the
FM-audio stream (tones +1200/+2200 Hz of a real signal); see
``afsk_demod_config``.
"""

import numpy as np

from radiosonde_auto_rx_jax.models import register

BAUD = 1200
TONE_MARK, TONE_SPACE = 1200, 2200      # 1 = 1200 Hz, 0 = 2200 Hz

SOH = 0x01
PKT_PTU, PKT_GPS, PKT_XDATA, PKT_EPTU, PKT_EGPS = 0x01, 0x02, 0x03, \
    0x04, 0x05

# header for bit-stream search: sync ones + 8N1(SOH)
HEADER = "1111111111" + "0100000001"


def afsk_demod_config(fs: int = 48000):
    """FSKConfig demodulating Bell-202 audio fed as a real signal
    (imag plane zero): the estimator window selects the positive tones."""
    from radiosonde_auto_rx_jax.demod.fsk import FSKConfig
    return FSKConfig(fs=fs, rs=BAUD, m=2, p=8, nsym=120,
                     est_min=800, est_max=2600)


def afsk_fm_audio(iq_planes, fs: int = 48000):
    """IQ planes [..., 2, T] -> band-limited FM audio [..., T].

    Mirrors imet4iq's front-end (imet4iq.c:1352,1516-1517): an IF
    lowpass (16 kHz bandwidth) before the discriminator and an audio
    lowpass after it.  Without the IF filter the discriminator sees the
    full channel's noise and the AFSK chain loses ~3 dB of sensitivity.
    """
    import jax.numpy as jnp
    from radiosonde_auto_rx_jax.ops.fir import design_lowpass, fir_filter
    from radiosonde_auto_rx_jax.ops.fm import fm_discriminate_planes
    x = jnp.asarray(iq_planes, jnp.float32)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    K, two, T = x.shape
    h_if = jnp.asarray(design_lowpass(8e3 / fs, 97))
    xf = fir_filter(x.reshape(K * 2, T), h_if).reshape(K, 2, T)
    audio = fm_discriminate_planes(xf)
    h_fm = jnp.asarray(design_lowpass(4e3 / fs, 97))
    audio = fir_filter(audio, h_fm)
    return audio[0] if squeeze else audio


def crc16_1d0f(data):
    rem = 0x1D0F
    for b in data:
        rem ^= int(b) << 8
        for _ in range(8):
            rem = ((rem << 1) ^ 0x1021 if rem & 0x8000 else rem << 1) \
                & 0xFFFF
    return rem


def bits_8n1_decode(bits):
    """10-bit groups -> bytes; an all-ones group marks frame end."""
    out = []
    n = len(bits) // 10
    for i in range(n):
        g = bits[10 * i:10 * i + 10]
        if g.sum() == 10:
            break
        byte = int((g[1:9] << np.arange(8)).sum())
        out.append(byte)
    return np.array(out, dtype=np.uint8)


def bytes_8n1_encode(data):
    out = np.ones((len(data), 10), dtype=np.uint8)
    out[:, 0] = 0
    for i, b in enumerate(data):
        out[i, 1:9] = (int(b) >> np.arange(8)) & 1
    return out.reshape(-1)


@register("IMET")
class IMet4Decoder:
    """iMet-1/4 decoder: AFSK bit stream -> telemetry.

    The serial is synthesized later from power-on time + frequency
    (station/telemetry.py enrich, reference autorx/sonde_specific.py:54).
    """

    HEADER = HEADER

    def __init__(self, jsn_freq_khz: int = 0):
        self.jsn_freq_khz = jsn_freq_khz

    def decode_bits(self, bits, soft=None):
        from radiosonde_auto_rx_jax.demod.framing import find_frame_starts
        bits = np.asarray(bits, dtype=np.uint8)
        out = []
        # header search leaves us at the bit after 8N1(SOH): back up one
        # byte so the packet walk sees SOH itself
        for s in find_frame_starts(bits, HEADER, max_errors=1):
            frame_bits = bits[s - 10:s - 10 + 1200]
            t = self.decode_frame_bits(frame_bits)
            if t:
                out.append(t)
        return out

    def decode_frame_bits(self, frame_bits):
        byteframe = bits_8n1_decode(np.asarray(frame_bits, dtype=np.uint8))
        return self.decode_frame(byteframe)

    def decode_frame(self, byteframe):
        """Packet walk (imet4iq.c print_frame :1240-1315)."""
        gps = ptu = None
        aux = []
        ofs = 0
        n = len(byteframe)
        while ofs + 2 <= n and byteframe[ofs] == SOH:
            pid = int(byteframe[ofs + 1])
            if pid in (PKT_GPS, PKT_EGPS):
                crcpos = 0x10 if pid == PKT_GPS else 0x1C
                pkt = byteframe[ofs:ofs + crcpos + 2]
                if len(pkt) < crcpos + 2:
                    break
                if ((int(pkt[0x10]) << 8) | int(pkt[0x10 + 1])) == \
                        crc16_1d0f(pkt[:0x10]):
                    gps = self._parse_gps(pkt, pid)
                ofs += crcpos + 2
            elif pid in (PKT_PTU, PKT_EPTU):
                crcpos = 0x12 if pid == PKT_EPTU else 0x0C
                pkt = byteframe[ofs:ofs + crcpos + 2]
                if len(pkt) < crcpos + 2:
                    break
                if ((int(pkt[crcpos]) << 8) | int(pkt[crcpos + 1])) == \
                        crc16_1d0f(pkt[:crcpos]):
                    ptu = self._parse_ptu(pkt)
                ofs += crcpos + 2
            elif pid == PKT_XDATA:
                if ofs + 3 > n:
                    break
                N = int(byteframe[ofs + 2])
                if N <= 0 or ofs + 3 + N + 2 > n:
                    break
                pkt = byteframe[ofs:ofs + 3 + N + 2]
                if ((int(pkt[3 + N]) << 8) | int(pkt[3 + N + 1])) == \
                        crc16_1d0f(pkt[:3 + N]):
                    aux.append("".join("%02X" % b for b in pkt[3:3 + N]))
                ofs += N + 5
            else:
                break

        if gps is None or ptu is None:
            return None
        telem = {
            "type": "IMET",
            "frame": ptu["frame"],
            "id": "IMET-xxxx",          # synthesized by enrichment
            "datetime": "%02d:%02d:%02dZ" % (gps["hour"], gps["min"],
                                             gps["sec"]),
            "lat": round(gps["lat"], 5),
            "lon": round(gps["lon"], 5),
            "alt": gps["alt"],
            "sats": gps["sats"],
            "temp": round(ptu["temp"], 2),
            "humidity": round(ptu["humidity"], 2),
            "pressure": round(ptu["pressure"], 2),
            "batt": round(ptu["batt"], 1),
            "ref_datetime": "GPS",
            "ref_position": "MSL",
        }
        if aux:
            telem["aux"] = "#".join(aux)
        if self.jsn_freq_khz:
            telem["freq"] = self.jsn_freq_khz
        return telem

    @staticmethod
    def _parse_gps(pkt, pid):
        lat = float(np.frombuffer(bytes(pkt[0x02:0x06]), "<f4")[0])
        lon = float(np.frombuffer(bytes(pkt[0x06:0x0A]), "<f4")[0])
        alt = ((int(pkt[0x0B]) << 8) | int(pkt[0x0A])) - 5000
        sats = int(pkt[0x0C])
        tim = 0x0D if pid == PKT_GPS else 0x19
        return dict(lat=lat, lon=lon, alt=alt, sats=sats,
                    hour=int(pkt[tim]), min=int(pkt[tim + 1]),
                    sec=int(pkt[tim + 2]))

    @staticmethod
    def _parse_ptu(pkt):
        P = int(pkt[0x04]) | (int(pkt[0x05]) << 8) | (int(pkt[0x06]) << 16)
        T = int(pkt[0x07]) | (int(pkt[0x08]) << 8)
        if T & 0x8000:
            T -= 0x10000
        U = int(pkt[0x09]) | (int(pkt[0x0A]) << 8)
        bat = int(pkt[0x0B])
        frame = int(pkt[0x02]) | (int(pkt[0x03]) << 8)
        return dict(pressure=P / 100.0, temp=T / 100.0,
                    humidity=U / 100.0, batt=bat / 10.0, frame=frame)


# --------------------------------------------------------------------------- #
# encoder fixture
# --------------------------------------------------------------------------- #

def encode_gps_packet(lat=1.23456, lon=103.9876, alt=7000, sats=9,
                      time=(11, 22, 33)):
    pkt = np.zeros(0x12, dtype=np.uint8)
    pkt[0], pkt[1] = SOH, PKT_GPS
    pkt[0x02:0x06] = np.frombuffer(np.float32(lat).tobytes(), np.uint8)
    pkt[0x06:0x0A] = np.frombuffer(np.float32(lon).tobytes(), np.uint8)
    a = alt + 5000
    pkt[0x0A], pkt[0x0B] = a & 0xFF, (a >> 8) & 0xFF
    pkt[0x0C] = sats
    pkt[0x0D:0x10] = time
    crc = crc16_1d0f(pkt[:0x10])
    pkt[0x10], pkt[0x11] = (crc >> 8) & 0xFF, crc & 0xFF
    return pkt


def encode_eptu_packet(frame=345, P=320.55, T=-12.34, U=45.67, bat=5.1,
                       Tint=10.0, Tpr=11.0, Tu=12.0):
    pkt = np.zeros(0x14, dtype=np.uint8)
    pkt[0], pkt[1] = SOH, PKT_EPTU
    pkt[0x02], pkt[0x03] = frame & 0xFF, (frame >> 8) & 0xFF
    p = int(round(P * 100))
    pkt[0x04], pkt[0x05], pkt[0x06] = p & 0xFF, (p >> 8) & 0xFF, \
        (p >> 16) & 0xFF
    t = int(round(T * 100)) & 0xFFFF
    pkt[0x07], pkt[0x08] = t & 0xFF, (t >> 8) & 0xFF
    u = int(round(U * 100))
    pkt[0x09], pkt[0x0A] = u & 0xFF, (u >> 8) & 0xFF
    pkt[0x0B] = int(round(bat * 10))
    for off, val in ((0x0C, Tint), (0x0E, Tpr), (0x10, Tu)):
        v = int(round(val * 100)) & 0xFFFF
        pkt[off], pkt[off + 1] = v & 0xFF, (v >> 8) & 0xFF
    crc = crc16_1d0f(pkt[:0x12])
    pkt[0x12], pkt[0x13] = (crc >> 8) & 0xFF, crc & 0xFF
    return pkt


def encode_frame_bits(packets, sync_bits=40):
    """Packets -> 8N1 bit stream with leading sync ones."""
    data = np.concatenate(packets)
    return np.concatenate([np.ones(sync_bits, dtype=np.uint8),
                           bytes_8n1_encode(data),
                           np.ones(20, dtype=np.uint8)])


def afsk_modulate(bits, fs=48000):
    """Bell-202 audio: 1 -> 1200 Hz, 0 -> 2200 Hz, phase continuous."""
    spb = fs // BAUD
    f = np.where(np.repeat(bits, spb) == 1, TONE_MARK, TONE_SPACE)
    ph = 2 * np.pi * np.cumsum(f) / fs
    return np.sin(ph).astype(np.float32)
