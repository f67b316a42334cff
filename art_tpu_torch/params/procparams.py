"""ProcParams: typed processing parameters + `.arp` codec (a copy of
``art_tpu/params/procparams.py`` without the snapshot sidecars, so that
both packages read and write a profile alike).

Reference: ``rtengine/procparams.{h,cc}`` (~8k LoC). Parameters are plain
dataclasses; each carries its `.arp` group name and a field->key spec so a
single generic codec (`to_keyfile`/`update_from_keyfile`) handles
serialization. Unknown groups/keys are preserved in ``ProcParams.extra`` so
sidecars written by the reference round-trip losslessly.

Partial-profile semantics (reference ``PartialProfile``,
``procparams.h:1769-1815``): loading a keyfile only overrides the fields
whose keys are present — exactly how ART composes default -> -p profiles ->
sidecar (``rtgui/main-cli.cc:820-846``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import ClassVar

from art_tpu_torch.params.keyfile import KeyFile

PP_VERSION = 1040  # ART ppVersion this codec targets

# curve type tags re-exported for param defaults
DCT_LINEAR = 0
FCT_LINEAR = 0


# ---------------------------------------------------------------------------
# declarative field spec: field name -> (arp key, kind[, enum map])
# kinds: b=bool, i=int, f=float, s=str, dl=double list (curves),
#        e=enum str<->python str via map {python: arp}
# ---------------------------------------------------------------------------

def _spec(**kwargs):
    return kwargs


class ParamGroup:
    """Mixin implementing the generic .arp codec via ARP_GROUP/ARP_SPEC."""

    ARP_GROUP: ClassVar[str] = ""
    ARP_SPEC: ClassVar[dict] = {}

    def to_keyfile(self, kf: KeyFile):
        for fname, spec in self.ARP_SPEC.items():
            key, kind = spec[0], spec[1]
            val = getattr(self, fname)
            if kind == "e":
                emap = spec[2]
                val = emap.get(val, val)
            if kind == "dl":
                val = list(val)
            kf.set(self.ARP_GROUP, key, val)

    def update_from_keyfile(self, kf: KeyFile):
        g = self.ARP_GROUP
        if g not in kf.groups:
            return False
        for fname, spec in self.ARP_SPEC.items():
            key, kind = spec[0], spec[1]
            if not kf.has(g, key):
                continue
            if kind == "b":
                setattr(self, fname, kf.get_bool(g, key))
            elif kind == "i":
                setattr(self, fname, kf.get_int(g, key))
            elif kind == "f":
                setattr(self, fname, kf.get_float(g, key))
            elif kind == "s":
                setattr(self, fname, kf.get_string(g, key))
            elif kind == "dl":
                setattr(self, fname, kf.get_double_list(g, key))
            elif kind == "e":
                emap = spec[2]
                rev = {v: k for k, v in emap.items()}
                raw = kf.get_string(g, key)
                setattr(self, fname, rev.get(raw, getattr(self, fname)))
        return True


def _dl(*values):
    return field(default_factory=lambda: list(values))


# ---------------------------------------------------------------------------
# groups (defaults match the reference constructors in procparams.cc)
# ---------------------------------------------------------------------------

@dataclass
class GeneralParams(ParamGroup):
    ARP_GROUP = "General"
    ARP_SPEC = _spec(rank=("Rank", "i"), color_label=("ColorLabel", "i"),
                     in_trash=("InTrash", "b"))
    rank: int = 0
    color_label: int = 0
    in_trash: bool = False


@dataclass
class ExposureParams(ParamGroup):
    # procparams.cc:1528-1534
    ARP_GROUP = "Exposure"
    HR_MAP = {"Off": "Off", "Blend": "Blend", "Color": "Color",
              "ColorSoft": "Balanced"}
    ARP_SPEC = _spec(
        enabled=("Enabled", "b"),
        expcomp=("Compensation", "f"),
        black=("Black", "f"),
        hrmode=("HLRecovery", "e", HR_MAP),
        hrblur=("HLRecoveryBlur", "f"),
    )
    enabled: bool = True
    expcomp: float = 0.0
    black: float = 0.0
    hrmode: str = "Off"  # Off | Blend | Color | ColorSoft (procparams.h:525-533)
    hrblur: float = 0.0


@dataclass
class SaturationParams(ParamGroup):
    # procparams.cc:1554-1558
    ARP_GROUP = "Saturation"
    ARP_SPEC = _spec(enabled=("Enabled", "b"), saturation=("Saturation", "i"),
                     vibrance=("Vibrance", "i"))
    enabled: bool = False
    saturation: int = 0
    vibrance: int = 0


TC_MODE_MAP = {
    "Standard": "Standard", "FilmLike": "FilmLike",
    "SatAndValueBlending": "SatAndValueBlending",
    "WeightedStd": "WeightedStd", "Luminance": "Luminance",
    "Perceptual": "Perceptual", "Neutral": "Neutral",
}
BC_MODE_MAP = {"Linear": "Linear", "Rolloff": "Rolloff", "SCurve": "SCurve"}


@dataclass
class ToneCurveParams(ParamGroup):
    # procparams.cc:1576-1595; save :3568-3605
    ARP_GROUP = "ToneCurve"
    ARP_SPEC = _spec(
        enabled=("Enabled", "b"),
        contrast=("Contrast", "i"),
        histmatching=("HistogramMatching", "b"),
        from_histmatching=("CurveFromHistogramMatching", "b"),
        curve_mode=("CurveMode", "e", TC_MODE_MAP),
        curve_mode2=("CurveMode2", "e", TC_MODE_MAP),
        curve=("Curve", "dl"),
        curve2=("Curve2", "dl"),
        saturation=("Saturation", "dl"),
        saturation2=("Saturation2", "dl"),
        perceptual_strength=("PerceptualStrength", "i"),
        contrast_legacy=("ContrastLegacyMode", "b"),
        white_point=("WhitePoint", "f"),
        basecurve=("BaseCurve", "e", BC_MODE_MAP),
    )
    enabled: bool = False
    contrast: int = 0
    histmatching: bool = False
    from_histmatching: bool = False
    curve: list = _dl(DCT_LINEAR)
    curve2: list = _dl(DCT_LINEAR)
    curve_mode: str = "Neutral"
    curve_mode2: str = "Neutral"
    saturation: list = _dl(FCT_LINEAR)
    saturation2: list = _dl(DCT_LINEAR)
    perceptual_strength: int = 100
    contrast_legacy: bool = False
    white_point: float = 1.0
    basecurve: str = "Linear"


@dataclass
class WBParams(ParamGroup):
    # procparams.cc:1807-1814
    ARP_GROUP = "White Balance"
    METHOD_MAP = {"Camera": "Camera", "Auto": "Auto", "Custom": "Custom",
                  "CustomTemp": "CustomTemp", "CustomMult": "CustomMult",
                  "CustomMultLegacy": "CustomMultLegacy"}
    ARP_SPEC = _spec(
        enabled=("Enabled", "b"),
        method=("Setting", "e", METHOD_MAP),
        temperature=("Temperature", "i"),
        green=("Green", "f"),
        equal=("Equal", "f"),
        mult=("Multipliers", "dl"),
    )
    enabled: bool = True
    method: str = "Camera"
    temperature: int = 6504
    green: float = 1.0
    equal: float = 1.0
    mult: list = _dl(1.0, 1.0, 1.0)


@dataclass
class ColorManagementParams(ParamGroup):
    # reference ColorManagementParams (procparams.h); "Color Management" group
    ARP_GROUP = "Color Management"
    ARP_SPEC = _spec(
        input_profile=("InputProfile", "s"),
        working_profile=("WorkingProfile", "s"),
        output_profile=("OutputProfile", "s"),
        apply_hue_sat_map=("ApplyHueSatMap", "b"),
        apply_look_table=("ApplyLookTable", "b"),
        apply_baseline_exposure=("ApplyBaselineExposureOffset", "b"),
        dcp_illuminant=("DCPIlluminant", "i"),
        dcp_look_early=("DCPLookEarly", "b"),
        output_bpc=("OutputBPC", "b"),
        tone_curve=("ToneCurve", "b"),
        input_cat=("InputProfileCAT", "b"),
        output_intent=("OutputProfileIntent", "s"),
    )
    # ToneCurve = apply the DCP's embedded tone curve (icm.toneCurve)
    tone_curve: bool = False
    input_cat: bool = False
    output_intent: str = "Relative"
    input_profile: str = "(cameraICC)"
    working_profile: str = "Rec2020"
    output_profile: str = "RTv4_sRGB"
    apply_hue_sat_map: bool = True
    apply_look_table: bool = False
    apply_baseline_exposure: bool = True
    dcp_illuminant: int = 0
    dcp_look_early: bool = False
    output_bpc: bool = True


BAYER_METHODS = ("amaze", "rcd", "lmmse", "igv", "amazebilinear",
                 "rcdbilinear", "vng4", "fast", "mono", "pixelshift", "none")
XTRANS_METHODS = ("4-pass", "3-pass (best)", "2-pass", "1-pass (medium)",
                  "fast", "mono", "none")


@dataclass
class BayerSensorParams(ParamGroup):
    # RAWParams::BayerSensor (procparams.cc:3013-3037 method strings)
    ARP_GROUP = "RAW Bayer"
    ARP_SPEC = _spec(
        method=("Method", "s"),
        border=("Border", "i"),
        ccSteps=("CcSteps", "i"),
        black0=("PreBlack0", "f"),
        black1=("PreBlack1", "f"),
        black2=("PreBlack2", "f"),
        black3=("PreBlack3", "f"),
        black_enabled=("PreBlackEnabled", "b"),
        two_green=("PreTwoGreen", "b"),
        linenoise=("LineDenoise", "f"),
        linenoise_direction=("LineDenoiseDirection", "i"),
        green_eq=("GreenEqThreshold", "f"),
        green_eq_enabled=("PreprocessingEnabled", "b"),
        dcb_iterations=("DCBIterations", "i"),
        dcb_enhance=("DCBEnhance", "b"),
        lmmse_iterations=("LMMSEIterations", "i"),
        dual_demosaic_auto_contrast=("DualDemosaicAutoContrast", "b"),
        dual_demosaic_contrast=("DualDemosaicContrast", "f"),
        pdaf_lines_filter=("PDAFLinesFilter", "b"),
        dynamic_row_noise_filter=("DynamicRowNoiseFilter", "b"),
        image_num=("ImageNum", "i"),
    )
    method: str = "amaze"
    border: int = 4
    ccSteps: int = 0
    black0: float = 0.0
    black1: float = 0.0
    black2: float = 0.0
    black3: float = 0.0
    black_enabled: bool = False
    two_green: bool = True
    linenoise: float = 0.0
    linenoise_direction: int = 3
    green_eq: float = 0.0
    green_eq_enabled: bool = False
    dcb_iterations: int = 2
    dcb_enhance: bool = True
    lmmse_iterations: int = 2
    dual_demosaic_auto_contrast: bool = True
    dual_demosaic_contrast: float = 20.0
    pdaf_lines_filter: bool = False
    dynamic_row_noise_filter: bool = False
    image_num: int = 0


@dataclass
class XTransSensorParams(ParamGroup):
    ARP_GROUP = "RAW X-Trans"
    ARP_SPEC = _spec(
        method=("Method", "s"),
        dual_demosaic_auto_contrast=("DualDemosaicAutoContrast", "b"),
        dual_demosaic_contrast=("DualDemosaicContrast", "f"),
        border=("Border", "i"),
        ccSteps=("CcSteps", "i"),
        black_red=("PreBlackRed", "f"),
        black_green=("PreBlackGreen", "f"),
        black_blue=("PreBlackBlue", "f"),
        black_enabled=("PreBlackEnabled", "b"),
    )
    method: str = "3-pass (best)"
    dual_demosaic_auto_contrast: bool = True
    dual_demosaic_contrast: float = 20.0
    border: int = 7
    ccSteps: int = 0
    black_red: float = 0.0
    black_green: float = 0.0
    black_blue: float = 0.0
    black_enabled: bool = False


@dataclass
class RAWParams(ParamGroup):
    # RAWParams (procparams.cc:3114+); CA/DF/FF/hot-dead pixel controls
    ARP_GROUP = "RAW"
    ARP_SPEC = _spec(
        df_file=("DarkFrame", "s"),
        df_autoselect=("DarkFrameAuto", "b"),
        df_enabled=("DarkFrameEnabled", "b"),
        ff_file=("FlatFieldFile", "s"),
        ff_autoselect=("FlatFieldAutoSelect", "b"),
        ff_enabled=("FlatFieldEnabled", "b"),
        ff_embedded=("FlatFieldUseEmbedded", "b"),
        ff_blur_radius=("FlatFieldBlurRadius", "i"),
        ff_blur_type=("FlatFieldBlurType", "s"),
        ff_auto_clip=("FlatFieldAutoClipControl", "b"),
        ff_clip_control=("FlatFieldClipControl", "i"),
        ca_enabled=("CAEnabled", "b"),
        ca_autocorrect=("CA", "b"),
        ca_auto_iterations=("CAAutoIterations", "i"),
        ca_avoid_colourshift=("CAAvoidColourshift", "b"),
        ca_red=("CARed", "f"),
        ca_blue=("CABlue", "f"),
        hotdead_enabled=("HotDeadPixelEnabled", "b"),
        hotpixel_filter=("HotPixelFilter", "b"),
        deadpixel_filter=("DeadPixelFilter", "b"),
        hotdead_thresh=("HotDeadPixelThresh", "i"),
        expos=("PreExposure", "f"),
        expos_enabled=("PreExposureEnabled", "b"),
    )
    df_file: str = ""
    df_autoselect: bool = False
    df_enabled: bool = False
    ff_file: str = ""
    ff_autoselect: bool = False
    ff_enabled: bool = False
    ff_embedded: bool = False
    ff_blur_radius: int = 32
    ff_blur_type: str = "Area Flatfield"
    ff_auto_clip: bool = False
    ff_clip_control: int = 0
    ca_enabled: bool = False
    ca_autocorrect: bool = False
    ca_auto_iterations: int = 2
    ca_avoid_colourshift: bool = True
    ca_red: float = 0.0
    ca_blue: float = 0.0
    hotdead_enabled: bool = False
    hotpixel_filter: bool = False
    deadpixel_filter: bool = False
    hotdead_thresh: int = 100
    expos: float = 1.0
    expos_enabled: bool = False
    bayer: BayerSensorParams = field(default_factory=BayerSensorParams)
    xtrans: XTransSensorParams = field(default_factory=XTransSensorParams)

    def to_keyfile(self, kf):
        super().to_keyfile(kf)
        self.bayer.to_keyfile(kf)
        self.xtrans.to_keyfile(kf)

    def update_from_keyfile(self, kf):
        hit = super().update_from_keyfile(kf)
        hit |= self.bayer.update_from_keyfile(kf)
        hit |= self.xtrans.update_from_keyfile(kf)
        return hit


@dataclass
class CropParams(ParamGroup):
    ARP_GROUP = "Crop"
    ARP_SPEC = _spec(
        enabled=("Enabled", "b"), x=("X", "i"), y=("Y", "i"),
        w=("W", "i"), h=("H", "i"), fixed_ratio=("FixedRatio", "b"),
        ratio=("Ratio", "s"), orientation=("Orientation", "s"),
        guide=("Guide", "s"),
    )
    enabled: bool = False
    x: int = -1
    y: int = -1
    w: int = 15000
    h: int = 15000
    fixed_ratio: bool = False
    ratio: str = "As Image"
    orientation: str = "As Image"
    guide: str = "Frame"


@dataclass
class CoarseTransformParams(ParamGroup):
    ARP_GROUP = "Coarse Transformation"
    ARP_SPEC = _spec(rotate=("Rotate", "i"), hflip=("HorizontalFlip", "b"),
                     vflip=("VerticalFlip", "b"))
    rotate: int = 0
    hflip: bool = False
    vflip: bool = False


@dataclass
class ResizeParams(ParamGroup):
    ARP_GROUP = "Resize"
    ARP_SPEC = _spec(
        enabled=("Enabled", "b"), scale=("Scale", "f"),
        applies_to=("AppliesTo", "s"), data_specified=("DataSpecified", "i"),
        width=("Width", "i"), height=("Height", "i"), unit=("Unit", "s"),
        ppi=("PPI", "i"), allow_upscaling=("AllowUpscaling", "b"),
    )
    enabled: bool = False
    scale: float = 1.0
    applies_to: str = "Cropped area"
    data_specified: int = 3
    width: int = 900
    height: int = 900
    unit: str = "px"
    ppi: int = 300
    allow_upscaling: bool = False


@dataclass
class ChannelMixerParams(ParamGroup):
    ARP_GROUP = "Channel Mixer"
    ARP_SPEC = _spec(
        enabled=("Enabled", "b"),
        mode=("Mode", "i"),
        red=("Red", "dl"), green=("Green", "dl"), blue=("Blue", "dl"),
        hue_tweak=("HueTweak", "dl"), sat_tweak=("SatTweak", "dl"),
    )
    enabled: bool = False
    mode: int = 0  # 0=RGB_MATRIX 1=PRIMARIES_CHROMA
    # 1000 = 1.0 in the reference's integer encoding
    red: list = _dl(1000, 0, 0)
    green: list = _dl(0, 1000, 0)
    blue: list = _dl(0, 0, 1000)
    hue_tweak: list = _dl(0, 0, 0)
    sat_tweak: list = _dl(0, 0, 0)


@dataclass
class RGBCurvesParams(ParamGroup):
    ARP_GROUP = "RGB Curves"
    ARP_SPEC = _spec(
        enabled=("Enabled", "b"),
        rcurve=("rCurve", "dl"), gcurve=("gCurve", "dl"),
        bcurve=("bCurve", "dl"),
    )
    enabled: bool = False
    rcurve: list = _dl(DCT_LINEAR)
    gcurve: list = _dl(DCT_LINEAR)
    bcurve: list = _dl(DCT_LINEAR)


@dataclass
class HSLEqualizerParams(ParamGroup):
    ARP_GROUP = "HSL Equalizer"
    ARP_SPEC = _spec(
        enabled=("Enabled", "b"),
        hcurve=("HCurve", "dl"), scurve=("SCurve", "dl"),
        lcurve=("LCurve", "dl"), smoothing=("Smoothing", "i"),
    )
    enabled: bool = False
    hcurve: list = _dl(FCT_LINEAR)
    scurve: list = _dl(FCT_LINEAR)
    lcurve: list = _dl(FCT_LINEAR)
    smoothing: int = 0


@dataclass
class LabCurveParams(ParamGroup):
    ARP_GROUP = "Luminance Curve"
    ARP_SPEC = _spec(
        enabled=("Enabled", "b"),
        brightness=("Brightness", "i"),
        contrast=("Contrast", "i"),
        chromaticity=("Chromaticity", "i"),
        lcurve=("LCurve", "dl"),
        acurve=("aCurve", "dl"),
        bcurve=("bCurve", "dl"),
    )
    enabled: bool = False
    brightness: int = 0
    contrast: int = 0
    chromaticity: int = 0
    lcurve: list = _dl(DCT_LINEAR)
    acurve: list = _dl(DCT_LINEAR)
    bcurve: list = _dl(DCT_LINEAR)


@dataclass
class SharpeningParams(ParamGroup):
    ARP_GROUP = "Sharpening"
    ARP_SPEC = _spec(
        enabled=("Enabled", "b"),
        contrast=("Contrast", "f"),
        method=("Method", "s"),
        radius=("Radius", "f"),
        amount=("Amount", "i"),
        threshold=("Threshold", "dl"),
        only_edges=("OnlyEdges", "b"),
        edges_radius=("EdgedetectionRadius", "f"),
        edges_tolerance=("EdgeTolerance", "i"),
        halo_control=("HalocontrolEnabled", "b"),
        halo_control_amount=("HalocontrolAmount", "i"),
        deconv_radius=("DeconvRadius", "f"),
        deconv_amount=("DeconvAmount", "i"),
        deconv_auto_radius=("DeconvAutoRadius", "b"),
        deconv_corner_boost=("DeconvCornerBoost", "f"),
        deconv_corner_latitude=("DeconvCornerLatitude", "f"),
        psf_kernel=("PSFKernel", "s"),
        psf_iterations=("PSFIterations", "i"),
    )
    enabled: bool = False
    contrast: float = 20.0
    method: str = "rld"
    radius: float = 0.5
    amount: int = 200
    threshold: list = _dl(20, 80, 2000, 1200)
    only_edges: bool = False
    edges_radius: float = 1.9
    edges_tolerance: int = 1800
    halo_control: bool = False
    halo_control_amount: int = 85
    deconv_radius: float = 0.75
    deconv_amount: int = 100
    deconv_auto_radius: bool = True
    deconv_corner_boost: float = 0.0
    deconv_corner_latitude: float = 25.0
    psf_kernel: str = ""
    psf_iterations: int = 10


@dataclass
class DenoiseParams(ParamGroup):
    # DenoiseParams (procparams.h:749)
    ARP_GROUP = "Denoise"
    ARP_SPEC = _spec(
        enabled=("Enabled", "b"),
        color_space=("ColorSpace", "s"),
        aggressive=("Aggressive", "b"),
        gamma=("Gamma", "f"),
        luminance=("Luminance", "f"),
        luminance_detail=("LuminanceDetail", "f"),
        luminance_detail_threshold=("LuminanceDetailThreshold", "i"),
        chrominance_method=("ChrominanceMethod", "i"),
        chrominance_auto_factor=("ChrominanceAutoFactor", "f"),
        chrominance=("Chrominance", "f"),
        chrominance_redgreen=("ChrominanceRedGreen", "f"),
        chrominance_blueyellow=("ChrominanceBlueYellow", "f"),
        smoothing_enabled=("SmoothingEnabled", "b"),
        smoothing_method=("SmoothingMethod", "i"),
        guided_chroma_radius=("GuidedChromaRadius", "i"),
        guided_chroma_strength=("GuidedChromaStrength", "i"),
        nl_strength=("NLStrength", "i"),
        nl_detail=("NLDetail", "i"),
    )
    enabled: bool = False
    color_space: str = "RGB"
    aggressive: bool = False
    gamma: float = 1.7
    luminance: float = 0.0
    luminance_detail: float = 0.0
    luminance_detail_threshold: int = 0
    chrominance_method: int = 1  # 0=manual 1=auto_global
    chrominance_auto_factor: float = 1.0
    chrominance: float = 15.0
    chrominance_redgreen: float = 0.0
    chrominance_blueyellow: float = 0.0
    smoothing_enabled: bool = False
    smoothing_method: int = 1
    guided_chroma_radius: int = 3
    guided_chroma_strength: int = 100
    nl_strength: int = 0
    nl_detail: int = 50


@dataclass
class ImpulseDenoiseParams(ParamGroup):
    ARP_GROUP = "Impulse Denoising"
    ARP_SPEC = _spec(enabled=("Enabled", "b"), thresh=("Threshold", "i"))
    enabled: bool = False
    thresh: int = 50


@dataclass
class DefringeParams(ParamGroup):
    ARP_GROUP = "Defringing"
    ARP_SPEC = _spec(enabled=("Enabled", "b"), radius=("Radius", "f"),
                     threshold=("Threshold", "i"), huecurve=("HueCurve", "dl"))
    enabled: bool = False
    radius: float = 2.0
    threshold: int = 13
    huecurve: list = _dl(
        1, 0.166666667, 0., 0.35, 0.35, 0.347, 0., 0.35, 0.35, 0.513667426,
        0, 0.35, 0.35, 0.668944571, 0., 0.35, 0.35, 0.8287775246, 0.97835991,
        0.35, 0.35, 0.9908883827, 0., 0.35, 0.35,
    )


@dataclass
class DehazeParams(ParamGroup):
    ARP_GROUP = "Dehaze"
    ARP_SPEC = _spec(
        enabled=("Enabled", "b"), strength=("Strength", "dl"),
        show_depth_map=("ShowDepthMap", "b"), depth=("Depth", "i"),
        luminance=("Luminance", "b"), blackpoint=("Blackpoint", "i"),
    )
    enabled: bool = False
    # flat curve: constant 0.75 strength (procparams.cc:2696-2706)
    strength: list = _dl(1, 0.0, 0.75, 0.0, 0.0, 1.0, 0.75, 0.0, 0.0)
    show_depth_map: bool = False
    depth: int = 25
    luminance: bool = False
    blackpoint: int = 0


@dataclass
class FattalParams(ParamGroup):
    # DRCompression / Fattal'02 (tmo_fattal02.cc)
    ARP_GROUP = "FattalToneMapping"
    ARP_SPEC = _spec(enabled=("Enabled", "b"), threshold=("Threshold", "i"),
                     amount=("Amount", "i"),
                     satcontrol=("SaturationControl", "b"))
    enabled: bool = False
    threshold: int = 30
    amount: int = 20
    satcontrol: bool = False


@dataclass
class LogEncodingParams(ParamGroup):
    # LogEncodingParams (procparams.h:816)
    ARP_GROUP = "LogEncoding"
    ARP_SPEC = _spec(
        enabled=("Enabled", "b"), auto_gray=("Auto", "b"),
        auto_gain=("AutoGain", "b"), gain=("Gain", "f"),
        target_gray=("TargetGray", "f"), black_ev=("BlackEv", "f"),
        white_ev=("WhiteEv", "f"), regularization=("Regularization", "i"),
        satcontrol=("SaturationControl", "b"),
        highlight_compression=("HighlightCompression", "i"),
    )
    enabled: bool = False
    auto_gain: bool = True
    auto_gray: bool = True
    gain: float = 0.0
    target_gray: float = 18.0
    black_ev: float = -5.0
    white_ev: float = 10.0
    regularization: int = 60
    satcontrol: bool = False
    highlight_compression: int = 0


@dataclass
class ToneEqualizerParams(ParamGroup):
    # ToneEqualizerParams (procparams.h:848)
    ARP_GROUP = "ToneEqualizer"
    ARP_SPEC = _spec(
        enabled=("Enabled", "b"),
        band0=("Band0", "i"), band1=("Band1", "i"), band2=("Band2", "i"),
        band3=("Band3", "i"), band4=("Band4", "i"),
        regularization=("Regularization", "i"),
        pivot=("Pivot", "f"),
    )
    enabled: bool = False
    band0: int = 0
    band1: int = 0
    band2: int = 0
    band3: int = 0
    band4: int = 0
    regularization: int = 0
    pivot: float = 0.0


@dataclass
class SoftLightParams(ParamGroup):
    ARP_GROUP = "SoftLight"
    ARP_SPEC = _spec(enabled=("Enabled", "b"), strength=("Strength", "i"))
    enabled: bool = False
    strength: int = 30


@dataclass
class GrainParams(ParamGroup):
    ARP_GROUP = "Grain"
    ARP_SPEC = _spec(enabled=("Enabled", "b"), iso=("ISO", "i"),
                     strength=("Strength", "i"), color=("Color", "b"))
    enabled: bool = False
    iso: int = 400
    strength: int = 50
    color: bool = False


@dataclass
class FilmSimulationParams(ParamGroup):
    ARP_GROUP = "Film Simulation"
    ARP_SPEC = _spec(
        enabled=("Enabled", "b"), clut_filename=("ClutFilename", "s"),
        strength=("Strength", "i"), after_tone_curve=("AfterToneCurve", "b"),
        clut_params=("ClutParams", "s"),
    )
    enabled: bool = False
    clut_filename: str = ""
    strength: int = 100
    after_tone_curve: bool = False
    # external/CTL LUT parameter values: "name=v1,v2;name2=v;" (reference
    # save_lut_params procparams.cc:3483)
    clut_params: str = ""


@dataclass
class BlackWhiteParams(ParamGroup):
    ARP_GROUP = "Black & White"
    ARP_SPEC = _spec(
        enabled=("Enabled", "b"),
        filter_=("Filter", "s"),
        setting=("Setting", "s"),
        mixer_red=("MixerRed", "i"),
        mixer_green=("MixerGreen", "i"),
        mixer_blue=("MixerBlue", "i"),
        gamma_red=("GammaRed", "i"),
        gamma_green=("GammaGreen", "i"),
        gamma_blue=("GammaBlue", "i"),
        color_cast=("ColorCast", "dl"),
    )
    enabled: bool = False
    filter_: str = "None"
    setting: str = "RGB-Rel"
    mixer_red: int = 33
    mixer_green: int = 33
    mixer_blue: int = 33
    gamma_red: int = 0
    gamma_green: int = 0
    gamma_blue: int = 0
    color_cast: list = _dl(0, 0)


@dataclass
class CommonTransParams(ParamGroup):
    ARP_GROUP = "Common Properties for Transformations"
    ARP_SPEC = _spec(autofill=("AutoFill", "b"))
    autofill: bool = False


@dataclass
class RotateParams(ParamGroup):
    ARP_GROUP = "Rotation"
    ARP_SPEC = _spec(enabled=("Enabled", "b"), degree=("Degree", "f"))
    enabled: bool = False
    degree: float = 0.0


@dataclass
class DistortionParams(ParamGroup):
    ARP_GROUP = "Distortion"
    ARP_SPEC = _spec(enabled=("Enabled", "b"), amount=("Amount", "f"),
                     auto_compute=("Auto", "b"))
    enabled: bool = False
    amount: float = 0.0
    auto_compute: bool = False


@dataclass
class CACorrParams(ParamGroup):
    ARP_GROUP = "CACorrection"
    ARP_SPEC = _spec(enabled=("Enabled", "b"), red=("Red", "f"),
                     blue=("Blue", "f"))
    enabled: bool = False
    red: float = 0.0
    blue: float = 0.0


@dataclass
class VignettingParams(ParamGroup):
    ARP_GROUP = "Vignetting Correction"
    ARP_SPEC = _spec(enabled=("Enabled", "b"), amount=("Amount", "i"),
                     radius=("Radius", "i"), strength=("Strength", "i"),
                     centerX=("CenterX", "i"), centerY=("CenterY", "i"))
    enabled: bool = False
    amount: int = 0
    radius: int = 50
    strength: int = 1
    centerX: int = 0
    centerY: int = 0


@dataclass
class GradientParams(ParamGroup):
    ARP_GROUP = "Gradient"
    ARP_SPEC = _spec(enabled=("Enabled", "b"), degree=("Degree", "f"),
                     feather=("Feather", "i"), strength=("Strength", "f"),
                     centerX=("CenterX", "i"), centerY=("CenterY", "i"))
    enabled: bool = False
    degree: float = 0.0
    feather: int = 25
    strength: float = 0.6
    centerX: int = 0
    centerY: int = 0


@dataclass
class PCVignetteParams(ParamGroup):
    ARP_GROUP = "PCVignette"
    ARP_SPEC = _spec(enabled=("Enabled", "b"), strength=("Strength", "f"),
                     feather=("Feather", "i"), roundness=("Roundness", "i"),
                     centerX=("CenterX", "i"), centerY=("CenterY", "i"))
    enabled: bool = False
    strength: float = -0.3
    feather: int = 50
    roundness: int = 50
    centerX: int = 0
    centerY: int = 0


@dataclass
class PerspectiveParams(ParamGroup):
    ARP_GROUP = "Perspective"
    ARP_SPEC = _spec(
        enabled=("Enabled", "b"), horizontal=("Horizontal", "f"),
        vertical=("Vertical", "f"), angle=("Angle", "f"),
        shear=("Shear", "f"), flength=("FocalLength", "f"),
        cropfactor=("CropFactor", "f"), aspect=("Aspect", "f"),
    )
    enabled: bool = False
    horizontal: float = 0.0
    vertical: float = 0.0
    angle: float = 0.0
    shear: float = 0.0
    flength: float = 0.0
    cropfactor: float = 1.0
    aspect: float = 1.0


@dataclass
class LensProfParams(ParamGroup):
    ARP_GROUP = "LensProfile"
    ARP_SPEC = _spec(
        method=("LcMode", "s"), lcp_file=("LCPFile", "s"),
        use_dist=("UseDistortion", "b"), use_vign=("UseVignette", "b"),
        use_ca=("UseCA", "b"), lf_camera_make=("LFCameraMake", "s"),
        lf_camera_model=("LFCameraModel", "s"), lf_lens=("LFLens", "s"),
    )
    method: str = "none"  # none|lfauto|lfmanual|lcp|exif (procparams.cc:2295)
    lcp_file: str = ""
    use_dist: bool = True
    use_vign: bool = True
    use_ca: bool = False
    lf_camera_make: str = ""
    lf_camera_model: str = ""
    lf_lens: str = ""


@dataclass
class FilmNegativeParams(ParamGroup):
    ARP_GROUP = "Film Negative"
    ARP_SPEC = _spec(
        enabled=("Enabled", "b"), red_ratio=("RedRatio", "f"),
        green_exp=("GreenExponent", "f"), blue_ratio=("BlueRatio", "f"),
        ref_input=("RefInput", "dl"), ref_output=("RefOutput", "dl"),
        colorspace=("ColorSpace", "i"), back_compat=("BackCompat", "i"),
    )
    enabled: bool = False
    red_ratio: float = 1.36
    green_exp: float = 1.5
    blue_ratio: float = 0.86
    ref_input: list = _dl(0.0, 0.0, 0.0)
    ref_output: list = _dl(0.0, 0.0, 0.0)
    colorspace: int = 1
    back_compat: int = 0


@dataclass
class SpotEntry:
    """One clone-stamp spot (procparams.h SpotEntry:1144)."""

    source_x: float = 0.0
    source_y: float = 0.0
    target_x: float = 0.0
    target_y: float = 0.0
    radius: int = 25
    feather: float = 1.0
    opacity: float = 1.0
    detail: int = 2


@dataclass
class SpotParams(ParamGroup):
    """Spot removal (group "Spot Removal", dynamic Spot<N> keys)."""

    ARP_GROUP = "Spot Removal"
    ARP_SPEC = _spec(enabled=("Enabled", "b"))
    enabled: bool = False
    entries: list = field(default_factory=list)

    def to_keyfile(self, kf: KeyFile):
        super().to_keyfile(kf)
        for i, e in enumerate(self.entries):
            kf.set(self.ARP_GROUP, f"Spot{i + 1}",
                   [e.source_x, e.source_y, e.target_x, e.target_y,
                    float(e.radius), e.feather, e.opacity, float(e.detail)])

    def update_from_keyfile(self, kf: KeyFile):
        if not super().update_from_keyfile(kf):
            return False
        i = 1
        entries = []
        while kf.has(self.ARP_GROUP, f"Spot{i}"):
            v = kf.get_double_list(self.ARP_GROUP, f"Spot{i}")
            if len(v) >= 7:
                entries.append(SpotEntry(
                    source_x=v[0], source_y=v[1], target_x=v[2],
                    target_y=v[3], radius=int(v[4]), feather=v[5],
                    opacity=v[6], detail=int(v[7]) if len(v) > 7 else 2))
            i += 1
        if entries or kf.has(self.ARP_GROUP, "Spot1"):
            self.entries = entries
        return True


# .arp key <-> exiv2 key maps for the Exif/IPTC change lists
# (procparams.cc:3246-3284)
EXIF_ARP_KEYS = {
    "Copyright": "Exif.Image.Copyright",
    "Artist": "Exif.Image.Artist",
    "ImageDescription": "Exif.Image.ImageDescription",
    "Exif.UserComment": "Exif.Photo.UserComment",
    "ISOSpeed": "Exif.Photo.ISOSpeedRatings",
    "FNumber": "Exif.Photo.FNumber",
    "ShutterSpeed": "Exif.Photo.ExposureTime",
    "FocalLength": "Exif.Photo.FocalLength",
    "ExpComp": "Exif.Photo.ExposureBiasValue",
    "Flash": "Exif.Photo.Flash",
    "Make": "Exif.Image.Make",
    "Model": "Exif.Image.Model",
    "Lens": "Exif.Photo.LensModel",
    "DateTime": "Exif.Photo.DateTimeOriginal",
    "XResolution": "Exif.Image.XResolution",
    "YResolution": "Exif.Image.YResolution",
}
IPTC_ARP_KEYS = {
    "Title": "Iptc.Application2.ObjectName",
    "Category": "Iptc.Application2.Category",
    "SupplementalCategories": "Iptc.Application2.SuppCategory",
    "Keywords": "Iptc.Application2.Keywords",
    "Instructions": "Iptc.Application2.SpecialInstructions",
    "DateCreated": "Iptc.Application2.DateCreated",
    "Creator": "Iptc.Application2.Byline",
    "CreatorJobTitle": "Iptc.Application2.BylineTitle",
    "City": "Iptc.Application2.City",
    "Province": "Iptc.Application2.ProvinceState",
    "Country": "Iptc.Application2.CountryName",
    "TransReference": "Iptc.Application2.TransmissionReference",
    "Headline": "Iptc.Application2.Headline",
    "Credit": "Iptc.Application2.Credit",
    "Source": "Iptc.Application2.Source",
    "Copyright": "Iptc.Application2.Copyright",
    "Caption": "Iptc.Application2.Caption",
    "CaptionWriter": "Iptc.Application2.Writer",
}


@dataclass
class MetaDataParams(ParamGroup):
    """MetaData + the Exif/IPTC change-list groups (procparams.h:1212,
    save/load procparams.cc:4256-4288, 5950-6006)."""

    ARP_GROUP = "MetaData"
    ARP_SPEC = _spec(mode=("Mode", "i"), exif_keys=("ExifKeys", "s"),
                     notes=("Notes", "s"))
    mode: int = 1  # 0=tunnel 1=edit 2=strip
    exif_keys: str = ""
    notes: str = ""
    # change lists keyed by exiv2 names: {"Exif.Image.Artist": "..."} /
    # {"Iptc.Application2.Keywords": ["a", "b"]}
    exif: dict = field(default_factory=dict)
    iptc: dict = field(default_factory=dict)

    def to_keyfile(self, kf):
        super().to_keyfile(kf)
        for arp_key, exiv_key in EXIF_ARP_KEYS.items():
            if exiv_key in self.exif:
                kf.set("Exif", arp_key, str(self.exif[exiv_key]))
        for arp_key, exiv_key in IPTC_ARP_KEYS.items():
            if exiv_key in self.iptc:
                vals = self.iptc[exiv_key]
                if isinstance(vals, str):
                    vals = [vals]
                kf.set("IPTC", arp_key, ";".join(str(v) for v in vals) + ";")

    def update_from_keyfile(self, kf):
        hit = super().update_from_keyfile(kf)
        if "Exif" in kf.groups:
            for arp_key, val in kf.groups["Exif"].items():
                exiv_key = EXIF_ARP_KEYS.get(arp_key)
                if exiv_key:
                    self.exif[exiv_key] = val
                    hit = True
        if "IPTC" in kf.groups:
            for arp_key, val in kf.groups["IPTC"].items():
                exiv_key = IPTC_ARP_KEYS.get(arp_key)
                if exiv_key:
                    self.iptc[exiv_key] = [v for v in val.split(";") if v]
                    hit = True
        return hit


@dataclass
class OutputSharpeningParams(SharpeningParams):
    ARP_GROUP = "OutputSharpening"
    enabled: bool = False
    method: str = "rld"
    deconv_radius: float = 0.45
    deconv_auto_radius: bool = False


# ---------------------------------------------------------------------------
# the top-level bundle
# ---------------------------------------------------------------------------

@dataclass
class ProcParams:
    """All processing parameters for one image (procparams.h:1626-1756)."""

    general: GeneralParams = field(default_factory=GeneralParams)
    exposure: ExposureParams = field(default_factory=ExposureParams)
    saturation: SaturationParams = field(default_factory=SaturationParams)
    tone_curve: ToneCurveParams = field(default_factory=ToneCurveParams)
    wb: WBParams = field(default_factory=WBParams)
    icm: ColorManagementParams = field(default_factory=ColorManagementParams)
    raw: RAWParams = field(default_factory=RAWParams)
    crop: CropParams = field(default_factory=CropParams)
    coarse: CoarseTransformParams = field(default_factory=CoarseTransformParams)
    resize: ResizeParams = field(default_factory=ResizeParams)
    chmixer: ChannelMixerParams = field(default_factory=ChannelMixerParams)
    rgb_curves: RGBCurvesParams = field(default_factory=RGBCurvesParams)
    hsl: HSLEqualizerParams = field(default_factory=HSLEqualizerParams)
    lab_curve: LabCurveParams = field(default_factory=LabCurveParams)
    sharpening: SharpeningParams = field(default_factory=SharpeningParams)
    pr_sharpening: OutputSharpeningParams = field(
        default_factory=OutputSharpeningParams)
    denoise: DenoiseParams = field(default_factory=DenoiseParams)
    impulse_denoise: ImpulseDenoiseParams = field(
        default_factory=ImpulseDenoiseParams)
    defringe: DefringeParams = field(default_factory=DefringeParams)
    dehaze: DehazeParams = field(default_factory=DehazeParams)
    fattal: FattalParams = field(default_factory=FattalParams)
    logenc: LogEncodingParams = field(default_factory=LogEncodingParams)
    tone_equalizer: ToneEqualizerParams = field(
        default_factory=ToneEqualizerParams)
    softlight: SoftLightParams = field(default_factory=SoftLightParams)
    grain: GrainParams = field(default_factory=GrainParams)
    film_simulation: FilmSimulationParams = field(
        default_factory=FilmSimulationParams)
    bw: BlackWhiteParams = field(default_factory=BlackWhiteParams)
    common_trans: CommonTransParams = field(
        default_factory=CommonTransParams)
    rotate: RotateParams = field(default_factory=RotateParams)
    distortion: DistortionParams = field(default_factory=DistortionParams)
    cacorrection: CACorrParams = field(default_factory=CACorrParams)
    vignetting: VignettingParams = field(default_factory=VignettingParams)
    gradient: GradientParams = field(default_factory=GradientParams)
    pcvignette: PCVignetteParams = field(default_factory=PCVignetteParams)
    perspective: PerspectiveParams = field(default_factory=PerspectiveParams)
    lens_prof: LensProfParams = field(default_factory=LensProfParams)
    spot: SpotParams = field(default_factory=SpotParams)
    film_negative: FilmNegativeParams = field(
        default_factory=FilmNegativeParams)
    metadata: MetaDataParams = field(default_factory=MetaDataParams)
    pp_version: int = PP_VERSION
    # unknown groups preserved verbatim for lossless round-trip
    extra: dict = field(default_factory=dict)

    # -- codec -------------------------------------------------------------

    def _groups(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, ParamGroup):
                yield v

    def to_keyfile(self) -> KeyFile:
        kf = KeyFile()
        kf.set("Version", "AppVersion", "art-tpu " + "0.1.0")
        kf.set("Version", "Version", self.pp_version)
        for g in self._groups():
            g.to_keyfile(kf)
        for group, kv in self.extra.items():
            for k, v in kv.items():
                kf.groups.setdefault(group, {})[k] = v
        return kf

    def update_from_keyfile(self, kf: KeyFile):
        """Partial update: only keys present in `kf` override."""
        if kf.has("Version", "Version"):
            self.pp_version = kf.get_int("Version", "Version", PP_VERSION)
        known = {g.ARP_GROUP for g in self._groups()} | {"Version"}
        known |= {"RAW Bayer", "RAW X-Trans", "Exif", "IPTC"}
        for g in self._groups():
            g.update_from_keyfile(kf)
        for group, kv in kf.groups.items():
            if group not in known:
                self.extra.setdefault(group, {}).update(kv)

    def save(self, path):
        self.to_keyfile().save(path)

    @classmethod
    def load(cls, path) -> "ProcParams":
        pp = cls()
        pp.update_from_keyfile(KeyFile.load(path))
        return pp

    def apply_arp_text(self, text: str):
        self.update_from_keyfile(KeyFile.parse(text))
        return self

