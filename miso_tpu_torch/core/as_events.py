"""Legacy (pre-GFF) alternative-splicing event handling.

Parity targets: misopy/as_events.py (TwoIsoEvent, MISOEvents with
count-based filters, event-string parsers :303-414) and the event->gene
constructors in misopy/Gene.py:1042-1131 (se_event_to_gene,
tandem_utr_event_to_gene, afe_ale_event_to_gene).

Event names encode coordinates, e.g. an SE event:
``chr17:123:456:+;chr17:789:900:+;chr17:1000:1200:+`` (up;se;dn parts).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from miso_tpu_torch.core.gene import Exon, Gene, Isoform


@dataclass
class TwoIsoEvent:
    """A two-isoform event with its count summaries.
    Ref: misopy/as_events.py:27-86."""

    label: str
    event_type: str  # SE | RI | A3SS | A5SS | TandemUTR | AFE | ALE
    chrom: Optional[str] = None
    len: Optional[int] = None
    up_part_len: Optional[int] = None
    dn_part_len: Optional[int] = None
    # SE/RI counts
    num_inc: Optional[int] = None
    num_exc: Optional[int] = None
    num_common: Optional[int] = None
    # TandemUTR counts
    core_len: Optional[int] = None
    ext_len: Optional[int] = None
    num_core: Optional[int] = None
    num_ext: Optional[int] = None
    # AFE/ALE
    proximal_exons: List[dict] = field(default_factory=list)
    distal_exons: List[dict] = field(default_factory=list)
    num_proximal_body: Optional[int] = None
    num_distal_body: Optional[int] = None
    num_proximal_jxns: Optional[int] = None
    num_distal_jxns: Optional[int] = None


def parse_part(exon: str, delimiter: str = ":") -> Tuple[str, int, int, str]:
    """``chrom:start:end:strand`` -> tuple.
    Ref: as_events.py parse_part."""
    chrom, start, end, strand = exon.split(delimiter)
    return chrom, int(start), int(end), strand


def _part_info(exon: str) -> dict:
    """``chrom:start:end:strand`` -> info dict with length
    (as_events.py:303-312 parse_part's return shape)."""
    chrom, start, end, strand = parse_part(exon)
    return {"chrom": chrom, "start_coord": start, "end_coord": end,
            "strand": strand, "len": abs(end - start) + 1}


def parse_event_information(event_name: str, event_type: str,
                            delimiter: str = ";",
                            events_to_info: Optional[dict] = None
                            ) -> TwoIsoEvent:
    """Fill part lengths from a coordinate-encoded event name.  AFE/ALE
    names are opaque: their exon structure comes from a side-table
    (`events_to_info`, see load_afe_ale_events_information).
    Ref: as_events.py:314-341 parse_event_information."""
    ev = TwoIsoEvent(label=event_name, event_type=event_type)
    if event_type in ("SE", "RI"):
        up, mid, dn = event_name.split(delimiter)
        chrom, s, e, _ = parse_part(up)
        ev.chrom = chrom
        ev.up_part_len = e - s + 1
        _, s, e, _ = parse_part(mid)
        ev.len = e - s + 1
        _, s, e, _ = parse_part(dn)
        ev.dn_part_len = e - s + 1
    elif event_type == "TandemUTR":
        core, ext = event_name.split(delimiter)
        chrom, s, e, _ = parse_part(core)
        ev.chrom = chrom
        ev.core_len = e - s + 1
        _, s, e, _ = parse_part(ext)
        ev.ext_len = e - s + 1
    elif event_type in ("AFE", "ALE"):
        if not events_to_info or event_name not in events_to_info:
            raise KeyError("Unknown %s event %s (missing events info file)"
                           % (event_type, event_name))
        info = events_to_info[event_name]
        ev.proximal_exons = info["proximal_exons"]
        ev.distal_exons = info["distal_exons"]
        ev.chrom = ev.proximal_exons[0]["chrom"]
    else:
        raise ValueError("Unsupported event type: %s" % event_type)
    return ev


def parse_afe_ale_event(proximal_exons_str: str, distal_exons_str: str,
                        delimiter: str = ",") -> dict:
    """Comma-separated exon coordinate strings -> proximal/distal exon
    info lists.  Ref: as_events.py:343-365 parse_afe_ale_event."""
    proximal = [_part_info(x) for x in proximal_exons_str.split(delimiter)]
    distal = [_part_info(x) for x in distal_exons_str.split(delimiter)]
    if not proximal or not distal:
        raise ValueError("AFE/ALE event needs proximal and distal exons")
    return {"proximal_exons": proximal, "distal_exons": distal}


def load_afe_ale_events_information(events_info_filename: str,
                                    event_type: str,
                                    delimiter: str = "\t") -> dict:
    """TSV of (event_name, proximal exons, distal exons) -> info table.
    Ref: as_events.py:367-386."""
    if event_type not in ("AFE", "ALE"):
        raise ValueError("Event type must be AFE/ALE, got %s" % event_type)
    out: dict = {}
    with open(events_info_filename) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            name, proximal, distal = line.split(delimiter)
            out[name] = parse_afe_ale_event(proximal, distal)
    return out


def load_event_counts(events_filename: str, event_type: str,
                      delimiter: str = ";",
                      events_info_filename: Optional[str] = None
                      ) -> "MISOEvents":
    """Parse an mRNA-Seq event counts file (event_name TAB c1;c2;...)
    into a MISOEvents set.  Count layouts per type (as_events.py:388-504):
    SE up;se;dn;upinc;dninc;exc -- TandemUTR ext;core --
    AFE/ALE proximal_body;distal_body;proximal_jxns;distal_jxns --
    RI up;ri;dn;ejxn."""
    events_to_info = None
    if events_info_filename is not None and event_type in ("AFE", "ALE"):
        events_to_info = load_afe_ale_events_information(
            events_info_filename, event_type)
    events: Dict[str, TwoIsoEvent] = {}
    with open(events_filename) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            event_name, counts_str = line.split("\t")
            counts = [int(c) for c in counts_str.split(delimiter)]
            if len(counts) < 2:
                raise ValueError("Event %s has fewer than 2 counts"
                                 % event_name)
            ev = parse_event_information(event_name, event_type,
                                         events_to_info=events_to_info)
            if event_type == "SE":
                num_up, num_se, num_dn, num_upinc, num_dninc, num_exc = \
                    counts
                ev.num_inc = num_se + num_upinc + num_dninc
                ev.num_exc = num_exc
                ev.num_common = num_up + num_dn
            elif event_type == "TandemUTR":
                ev.num_ext, ev.num_core = counts
            elif event_type in ("AFE", "ALE"):
                (ev.num_proximal_body, ev.num_distal_body,
                 ev.num_proximal_jxns, ev.num_distal_jxns) = counts
            elif event_type == "RI":
                num_up, num_ri, num_dn, num_exc = counts
                ev.num_inc = num_ri
                ev.num_exc = num_exc
                ev.num_common = num_up + num_dn
            elif event_type == "MXE":
                raise ValueError("MXEs not supported.")
            else:
                raise ValueError("Unknown event type %s" % event_type)
            events[event_name] = ev
    return MISOEvents(2, event_type, events=events)


# ----------------------------------------------------- event -> gene

def se_event_to_gene(up_len: int, se_len: int, dn_len: int,
                     chrom: Optional[str], label: Optional[str] = None
                     ) -> Gene:
    """SE/RI event -> 3-part, 2-isoform gene (Gene.py:1042-1061)."""
    parts = [
        Exon(0, up_len - 1, label="A"),
        Exon(up_len, up_len + se_len - 1, label="B"),
        Exon(up_len + se_len, up_len + se_len + dn_len - 1, label="C"),
    ]
    isoforms = [Isoform((0, 1, 2), desc=["A", "B", "C"]),
                Isoform((0, 2), desc=["A", "C"])]
    return Gene(parts=parts, isoforms=isoforms, label=label, chrom=chrom)


def tandem_utr_event_to_gene(core_len: int, ext_len: int,
                             chrom: Optional[str],
                             label: Optional[str] = None) -> Gene:
    """TandemUTR event -> 2-part, 2-isoform gene (Gene.py:1063-1079)."""
    parts = [
        Exon(0, core_len - 1, label="TandemUTRCore"),
        Exon(core_len, core_len + ext_len - 1, label="TandemUTRExt"),
    ]
    isoforms = [
        Isoform((0, 1), desc=["TandemUTRCore", "TandemUTRExt"]),
        Isoform((0,), desc=["TandemUTRCore"]),
    ]
    return Gene(parts=parts, isoforms=isoforms, label=label, chrom=chrom)


def afe_ale_event_to_gene(proximal_exons: List[dict],
                          distal_exons: List[dict], event_type: str,
                          chrom: Optional[str],
                          read_len: Optional[int] = None,
                          overhang_len: Optional[int] = None,
                          label: Optional[str] = None) -> Gene:
    """AFE/ALE event -> 2 single-exon isoforms (Gene.py:1086-1127)."""
    njp = read_len if (read_len is not None and
                       overhang_len is not None) else 0
    distal_len = sum(e["len"] for e in distal_exons) + njp
    proximal_len = sum(e["len"] for e in proximal_exons) + njp
    distal = Exon(0, distal_len - 1, label="%sDistal" % event_type)
    proximal = Exon(distal_len, distal_len + proximal_len - 1,
                    label="%sProximal" % event_type)
    parts = [distal, proximal]
    isoforms = [Isoform((1,), desc=["%sProximal" % event_type]),
                Isoform((0,), desc=["%sDistal" % event_type])]
    return Gene(parts=parts, isoforms=isoforms, label=label, chrom=chrom)


class MISOEvents:
    """A set of two-isoform events with count-based filters.
    Ref: as_events.py:99-301."""

    def __init__(self, num_iso: int, event_type: str,
                 events: Optional[Dict[str, TwoIsoEvent]] = None):
        self.num_iso = num_iso
        self.event_type = event_type
        self.events: Dict[str, TwoIsoEvent] = events or {}

    def get_event(self, event_name: str) -> Optional[TwoIsoEvent]:
        return self.events.get(event_name)

    def __len__(self) -> int:
        return len(self.events)

    def filter_se_events(self, atleast_inc=1, atleast_exc=1,
                         atleast_sum=20) -> None:
        """Ref: as_events.py:194-210."""
        self.events = {
            name: ev for name, ev in self.events.items()
            if ((ev.num_inc or 0) >= atleast_inc and
                (ev.num_exc or 0) >= atleast_exc and
                ((ev.num_inc or 0) + (ev.num_exc or 0)
                 + (ev.num_common or 0)) >= atleast_sum)
        }

    filter_ri_events = filter_se_events  # same rule shape (as_events:176)

    def filter_tandem_utr_events(self, atleast_core=1, atleast_ext=1,
                                 atleast_sum=20) -> None:
        """Ref: as_events.py:158-174."""
        self.events = {
            name: ev for name, ev in self.events.items()
            if ((ev.num_core or 0) >= atleast_core and
                (ev.num_ext or 0) >= atleast_ext and
                ((ev.num_core or 0) + (ev.num_ext or 0)) >= atleast_sum)
        }

    def filter_afe_ale_events(self, atleast_proximal=0, atleast_distal=0,
                              proximal_distal_sum=20) -> None:
        """Ref: as_events.py:144-157."""
        def keep(ev):
            num_p = (ev.num_proximal_body or 0) + (ev.num_proximal_jxns or 0)
            num_d = (ev.num_distal_body or 0) + (ev.num_distal_jxns or 0)
            return (num_p >= atleast_proximal and num_d >= atleast_distal
                    and num_p + num_d >= proximal_distal_sum)

        self.events = {n: ev for n, ev in self.events.items() if keep(ev)}

    def filter_events(self) -> None:
        """Dispatch the per-type coverage filter (as_events.py:129-142)."""
        if self.event_type in ("SE", "RI"):
            self.filter_se_events()
        elif self.event_type == "TandemUTR":
            self.filter_tandem_utr_events()
        elif self.event_type in ("AFE", "ALE"):
            self.filter_afe_ale_events()
        else:
            raise ValueError("Unsupported event type for filtering: %s"
                             % self.event_type)

    def loaded_events_to_genes(self, read_len=None, overhang_len=None
                               ) -> Dict[str, Gene]:
        """Ref: as_events.py:233-269."""
        out: Dict[str, Gene] = {}
        for name, ev in self.events.items():
            if self.event_type in ("SE", "RI"):
                out[name] = se_event_to_gene(
                    ev.up_part_len, ev.len, ev.dn_part_len, ev.chrom,
                    label=ev.label)
            elif self.event_type == "TandemUTR":
                out[name] = tandem_utr_event_to_gene(
                    ev.core_len, ev.ext_len, ev.chrom, label=ev.label)
            elif self.event_type in ("AFE", "ALE"):
                out[name] = afe_ale_event_to_gene(
                    ev.proximal_exons, ev.distal_exons, self.event_type,
                    ev.chrom, read_len=read_len,
                    overhang_len=overhang_len, label=ev.label)
            else:
                raise ValueError(
                    "Unsupported event type: %s" % self.event_type)
        return out
