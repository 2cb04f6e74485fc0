"""Dictionary-driven CJK segmentation behind the TokenizerFactory seam
(counterpart of deeplearning4j_tpu/nlp/cjk.py; host code, kept as a copy).

Parity target: the reference vendors the Kuromoji Japanese morphological
analyzer (deeplearning4j-nlp-japanese/src/main/java/com/atilika/kuromoji/,
~6.8k LoC of lattice Viterbi over a bundled lexicon) plus Korean/UIMA
annotator plug-ins, all consumed through the SAME TokenizerFactory
extension point the rest of the NLP stack uses. This module proves that
seam with an actual analyzer rather than the char-bigram baseline
(CJKCharTokenizerFactory):

- ``LatticeSegmenter``: the full Kuromoji algorithm — bigram
  connection-cost Viterbi over a dictionary lattice
  (viterbi/ViterbiBuilder.java + ViterbiSearcher.java), char-class-based
  unknown-word insertion (CharacterDefinitions semantics: invoke/group
  per class), and part-of-speech tags carried on every token
  (``MorphToken``). Context disambiguates: すもももももももものうち
  parses noun-particle-noun…, which no unigram cost model can produce.
- ``DictionarySegmenter``: the lighter unigram tier (no connection
  costs): every dictionary word spans an edge with cost
  ``len-discounted``; unknown single characters get a penalty cost, so
  known multi-character words win over character soup. A small built-in
  Japanese function-word/common-noun lexicon is bundled; real
  deployments load a full lexicon with ``load_dictionary`` (one word per
  line, optionally ``word<TAB>cost[<TAB>pos]``).
- ``DictionaryTokenizerFactory``: the TokenizerFactory adapter — Han/Kana
  runs go through the segmenter, other text through whitespace rules;
  drop-in everywhere a DefaultTokenizerFactory is accepted (Word2Vec,
  vectorizers, SequenceVectors).
- ``mecab_tokenizer_factory()``: optional-dependency wrapper that returns
  a factory backed by ``fugashi``/``MeCab`` when one is importable
  (without one the wrapper raises with instructions; the tests drive it
  through a stub module), demonstrating the external-analyzer
  plug-in path the reference's add-on modules occupy.
"""

from __future__ import annotations

import unicodedata
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from deeplearning4j_tpu_torch.nlp.tokenization import (
    CJKCharTokenizerFactory, DefaultTokenizerFactory)

# Starter lexicon: Japanese particles/copulas + common vocabulary —
# enough to segment everyday sentences sensibly; extend with
# load_dictionary for real corpora (one word per line,
# ``word[<TAB>cost[<TAB>pos]]``).
_JA_NOUNS = (
    "私 僕 彼 彼女 猫 犬 鳥 魚 本 水 山 川 空 海 雨 雪 花 木 日本 東京 "
    "学校 先生 学生 友達 家族 電車 車 道 店 駅 会社 仕事 料理 写真 音楽 "
    "映画 言葉 名前 時間 今日 明日 昨日 今 朝 夜 昼 年 月 週 毎日 "
    "これ それ あれ ここ そこ どこ 何 誰 いつ "
    "人 男 女 子供 手 足 目 耳 口 頭 心 体 声 顔 力 お金 紙 部屋 家 国 "
    "町 村 世界 場所 物 事 話 問題 質問 答え 意味 理由 方法 結果 情報 "
    "電話 手紙 番号 文字 文章 漢字 言語 英語 日本語 外国 旅行 買い物 "
    "食事 パン 肉 野菜 果物 卵 牛乳 お茶 酒 天気 風 火 土 石 季節 "
    "春 夏 秋 冬 色 赤 青 白 黒 緑 時計 週末 休み 病院 銀行 図書館 "
    "公園 空港 橋 建物 窓 机 椅子 箱 袋 服 靴 帽子 眼鏡 傘 荷物 切符 "
    "新聞 雑誌 辞書 地下鉄 バス 飛行機 船 自転車 歌 絵 遊び 運動 練習 "
    "勉強 試験 授業 宿題 教室 鉛筆 ノート 意見 気持ち 気分 病気 薬 "
    "医者 警察 火事 事故 地震 台風 戦争 平和 歴史 文化 社会 経済 政治 "
    "法律 科学 技術 自然 動物 植物 言い方 考え方 みんな 全部 一部 最初 "
    "最後 次 前 後ろ 上 下 中 外 右 左 隣 間 近く 遠く 今年 去年 来年 "
    "今週 来週 先週 今月 来月 先月 午前 午後 半分 大学 高校 中学 小学校"
).split()
_JA_VERBS = (
    "食べる 飲む 行く 来る 見る 聞く 話す 読む 書く 買う 売る 作る "
    "使う 持つ 待つ 会う 言う 思う 知る 分かる 出る 入る 乗る 降りる "
    "歩く 走る 泳ぐ 飛ぶ 帰る 休む 働く 遊ぶ 学ぶ 教える 覚える "
    "忘れる 始める 終わる 開ける 閉める 消す 置く 取る 送る 届く 着く "
    "立つ 座る 寝る 起きる 死ぬ 生きる 住む 呼ぶ 答える 聞こえる "
    "見える 考える 感じる 信じる 笑う 泣く 怒る 歌う 踊る 洗う 切る "
    "貸す 借りる 返す 払う 探す 見つける 決める 選ぶ 変わる 変える "
    "動く 止まる 止める 続く 続ける 助ける 手伝う 頼む 渡す 受ける "
    "落ちる 落とす 上がる 下がる 登る 並ぶ 集まる 集める"
).split()
_JA_ADJS = (
    "好き 嫌い 大きい 小さい 新しい 古い 高い 安い 良い 悪い "
    "美しい 楽しい 嬉しい 悲しい 暑い 寒い 暖かい 涼しい 強い 弱い "
    "早い 速い 遅い 近い 遠い 長い 短い 広い 狭い 重い 軽い 明るい "
    "暗い 忙しい 簡単 難しい 易しい 便利 不便 静か 有名 大切 大事 "
    "元気 親切 丁寧 綺麗 汚い 危ない 安全 白い 黒い 赤い 青い 若い "
    "面白い つまらない 甘い 辛い 苦い 美味しい 痛い 眠い"
).split()
_JA_ADVS = (
    "とても すこし たくさん もっと まだ もう ずっと きっと 多分 全然 "
    "いつも 時々 たまに すぐ ゆっくり ちょっと かなり 本当に 特に "
    "例えば でも しかし だから それで そして また"
).split()
_JA_PARTICLES = "は が を に で と も の へ から まで より や か ね よ".split()
_JA_AUX = (
    "だ です ます でした した する して いる ある ない なかった "
    "れる られる せる たい ました ません だった でしょう だろう"
).split()

_BUILTIN_JA = (_JA_NOUNS + _JA_VERBS + _JA_ADJS + _JA_ADVS + _JA_PARTICLES
               + _JA_AUX)


class DictionarySegmenter:
    """Min-cost DP segmentation over a word dictionary (the lattice
    Viterbi at Kuromoji's core, with unigram costs only)."""

    #: cost charged per unknown character (a known word of length L costs
    #: L - bonus, so any dictionary word beats spelling it out)
    UNKNOWN_COST = 2.0
    KNOWN_BONUS = 0.5

    def __init__(self, words: Optional[Iterable[str]] = None,
                 costs: Optional[Dict[str, float]] = None):
        self._costs: Dict[str, float] = {}
        self._max_len = 1
        for w in (words if words is not None else _BUILTIN_JA):
            self.add_word(w)
        for w, c in (costs or {}).items():
            self.add_word(w, c)

    def add_word(self, word: str, cost: Optional[float] = None) -> None:
        if not word:
            return
        self._costs[word] = (float(cost) if cost is not None
                             else len(word) - self.KNOWN_BONUS)
        self._max_len = max(self._max_len, len(word))

    def load_dictionary(self, path: str) -> "DictionarySegmenter":
        """Load ``word`` or ``word<TAB>cost`` lines (full-lexicon path)."""
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if not parts or not parts[0]:
                    continue
                self.add_word(parts[0],
                              float(parts[1]) if len(parts) > 1 else None)
        return self

    def __contains__(self, word: str) -> bool:
        return word in self._costs

    def segment(self, text: str) -> List[str]:
        """Min-total-cost split of ``text``; ties prefer longer words
        (fewer segments)."""
        n = len(text)
        if n == 0:
            return []
        INF = float("inf")
        best = [INF] * (n + 1)
        back = [0] * (n + 1)
        nseg = [0] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] is INF:
                continue
            # unknown single character
            cand = best[i] + self.UNKNOWN_COST
            if (cand < best[i + 1]
                    or (cand == best[i + 1] and nseg[i] + 1 < nseg[i + 1])):
                best[i + 1] = cand
                back[i + 1] = i
                nseg[i + 1] = nseg[i] + 1
            # dictionary words starting at i
            for L in range(2, min(self._max_len, n - i) + 1):
                w = text[i:i + L]
                c = self._costs.get(w)
                if c is None:
                    continue
                j = i + L
                cand = best[i] + c
                if (cand < best[j]
                        or (cand == best[j] and nseg[i] + 1 < nseg[j])):
                    best[j] = cand
                    back[j] = i
                    nseg[j] = nseg[i] + 1
        out: List[str] = []
        j = n
        while j > 0:
            i = back[j]
            out.append(text[i:j])
            j = i
        out.reverse()
        return out


@dataclass(frozen=True)
class MorphToken:
    """One analyzed token: surface form + part of speech + whether it came
    from the dictionary (ViterbiNode.Type.KNOWN) or the unknown-word
    inserter (Type.UNKNOWN)."""
    surface: str
    pos: str
    known: bool


# Character classes for unknown-word handling, mirroring Kuromoji's
# CharacterDefinitions (char.def): per class (invoke, group, per-char cost,
# POS). ``invoke``: insert unknown nodes even when dictionary words match
# at this position; ``group``: one node per maximal same-class run instead
# of per character.
_CHAR_CLASSES: Dict[str, Tuple[bool, bool, float, str]] = {
    "KANJI": (False, False, 2.0, "noun"),
    "HIRAGANA": (False, False, 2.5, "unk"),
    "KATAKANA": (True, True, 1.0, "noun"),   # loanword runs are nouns
    "LATIN": (True, True, 1.0, "noun"),
    "NUMERIC": (True, True, 1.0, "noun"),
    "DEFAULT": (False, False, 3.0, "unk"),
}


def _char_class(ch: str) -> str:
    o = ord(ch)
    if 0x3040 <= o <= 0x309F:
        return "HIRAGANA"
    if 0x30A0 <= o <= 0x30FF or 0x31F0 <= o <= 0x31FF or o == 0xFF70 \
            or 0xFF66 <= o <= 0xFF9D:
        return "KATAKANA"
    if 0x4E00 <= o <= 0x9FFF or 0x3400 <= o <= 0x4DBF:
        return "KANJI"
    if ch.isascii() and ch.isalpha():
        return "LATIN"
    if unicodedata.category(ch) == "Nd":
        return "NUMERIC"
    return "DEFAULT"


# Default bigram connection costs over POS classes (the ConnectionCosts
# matrix tier — matrix.def in IPADIC, here a compact POS-level rendering:
# grammatical transitions are cheap, ungrammatical ones expensive).
_DEFAULT_CONNECTIONS: Dict[Tuple[str, str], float] = {
    ("noun", "particle"): 0.0, ("noun", "aux"): 0.1, ("noun", "noun"): 2.0,
    ("particle", "noun"): 0.0, ("particle", "verb"): 0.1,
    ("particle", "adj"): 0.1, ("particle", "particle"): 1.0,
    ("verb", "aux"): 0.0, ("verb", "particle"): 0.2,
    ("adj", "aux"): 0.1, ("adj", "noun"): 0.3,
    ("aux", "aux"): 0.1, ("aux", "particle"): 0.3,
    ("adv", "verb"): 0.1, ("adv", "adj"): 0.1,
    ("BOS", "particle"): 2.0, ("BOS", "aux"): 2.0,
    ("particle", "EOS"): 1.5, ("noun", "EOS"): 0.1, ("verb", "EOS"): 0.0,
    ("aux", "EOS"): 0.0, ("adj", "EOS"): 0.1,
}

# POS tags for the builtin starter lexicon (the TokenInfoDictionary tier),
# derived from the per-POS word lists above (nouns are the default).
_BUILTIN_POS: Dict[str, str] = {}
for _pos, _words in (("particle", _JA_PARTICLES), ("aux", _JA_AUX),
                     ("verb", _JA_VERBS), ("adj", _JA_ADJS),
                     ("adv", _JA_ADVS)):
    for _w in _words:
        _BUILTIN_POS[_w] = _pos


class LatticeSegmenter:
    """Connection-cost lattice Viterbi — the full Kuromoji tier.

    Upgrades DictionarySegmenter from unigram min-cost DP to the
    reference's actual algorithm (viterbi/ViterbiBuilder.java:69 build +
    ViterbiSearcher.java:68-117 search): every dictionary word spanning
    [i, j) becomes a lattice node carrying a word cost AND a POS class;
    path cost accumulates ``prev.path + connection(prev.pos, node.pos) +
    node.word_cost`` (ViterbiSearcher.updateNode:102), so the winning
    segmentation depends on grammatical CONTEXT, not just word lengths —
    the thing a unigram model cannot do (すもももももももものうち segments
    noun-particle-noun…, not noun-noun-noun). Unknown words follow
    CharacterDefinitions semantics (ViterbiBuilder.processUnknownWord:127):
    per character class, ``invoke`` inserts nodes even where dictionary
    matches exist, ``group`` spans maximal same-class runs (katakana
    loanwords, digits, latin), and each node carries the class's POS.

    BOS/EOS are real lattice nodes (ViterbiLattice.addBos/addEos), so
    sentence-position preferences participate in the search.
    """

    KNOWN_BONUS = 0.5

    def __init__(self, entries: Optional[Iterable] = None,
                 connections: Optional[Dict[Tuple[str, str], float]] = None,
                 default_connection: float = 0.5):
        self._entries: Dict[str, List[Tuple[str, float]]] = {}
        self._max_len = 1
        self._conn = dict(_DEFAULT_CONNECTIONS)
        if connections:
            self._conn.update(connections)
        self._default_conn = float(default_connection)
        if entries is None:
            for w in _BUILTIN_JA:
                self.add_word(w, pos=_BUILTIN_POS.get(w, "noun"))
        else:
            for e in entries:
                if isinstance(e, str):
                    self.add_word(e)
                else:
                    self.add_word(*e)

    # ------------------------------------------------------------ lexicon
    def add_word(self, word: str, pos: str = "noun",
                 cost: Optional[float] = None) -> None:
        if not word:
            return
        c = float(cost) if cost is not None else len(word) - self.KNOWN_BONUS
        self._entries.setdefault(word, []).append((pos, c))
        self._max_len = max(self._max_len, len(word))

    def set_connection(self, left_pos: str, right_pos: str,
                       cost: float) -> None:
        self._conn[(left_pos, right_pos)] = float(cost)

    def load_dictionary(self, path: str) -> "LatticeSegmenter":
        """``word``, ``word<TAB>cost`` or ``word<TAB>cost<TAB>pos`` lines."""
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if not parts or not parts[0]:
                    continue
                cost = float(parts[1]) if len(parts) > 1 and parts[1] else None
                pos = parts[2] if len(parts) > 2 else "noun"
                self.add_word(parts[0], pos=pos, cost=cost)
        return self

    def __contains__(self, word: str) -> bool:
        return word in self._entries

    def connection(self, left_pos: str, right_pos: str) -> float:
        return self._conn.get((left_pos, right_pos), self._default_conn)

    # ------------------------------------------------------------ lattice
    def _build(self, text: str):
        """Lattice nodes (start, end, surface, pos, cost, known), grouped
        by end position (the endIndexArr of ViterbiLattice.java)."""
        n = len(text)
        nodes: List[Tuple[int, int, str, str, float, bool]] = []
        classes = [_char_class(c) for c in text]  # O(n), computed once
        for start in range(n):
            found = False
            for L in range(1, min(self._max_len, n - start) + 1):
                w = text[start:start + L]
                for pos, cost in self._entries.get(w, ()):
                    nodes.append((start, start + L, w, pos, cost, True))
                    found = True
            cls = classes[start]
            invoke, group, char_cost, pos = _CHAR_CLASSES[cls]
            if invoke or not found:
                run_start = start == 0 or classes[start - 1] != cls
                if group and run_start:
                    # ONE grouped node per maximal same-class run
                    # (Kuromoji inserts the grouped unknown at the run
                    # head; O(total_chars) overall, not O(run^2))
                    end = start + 1
                    while end < n and classes[end] == cls:
                        end += 1
                    if end > start + 1:
                        nodes.append((start, end, text[start:end], pos,
                                      char_cost * (end - start), False))
                # single-char node at EVERY position keeps mid-run
                # dictionary words reachable (a word starting inside a
                # grouped run needs an incoming edge at its start)
                nodes.append((start, start + 1, text[start], pos,
                              char_cost, False))
        return nodes

    def tokenize(self, text: str) -> List[MorphToken]:
        """Best path through the lattice as analyzed tokens."""
        n = len(text)
        if n == 0:
            return []
        nodes = self._build(text)
        ends: List[List[int]] = [[] for _ in range(n + 1)]
        for idx, nd in enumerate(nodes):
            ends[nd[1]].append(idx)
        INF = float("inf")
        path = [INF] * len(nodes)
        back = [-1] * len(nodes)   # -1 = BOS, else node index
        for idx, (start, _e, _w, pos, cost, _k) in enumerate(nodes):
            if start == 0:
                path[idx] = self.connection("BOS", pos) + cost
                continue
            best = INF
            best_prev = None
            for p in ends[start]:
                if path[p] is INF:
                    continue
                cand = path[p] + self.connection(nodes[p][3], pos) + cost
                if cand < best:
                    best, best_prev = cand, p
            if best_prev is not None:
                path[idx] = best
                back[idx] = best_prev
        # EOS
        best, best_last = INF, None
        for p in ends[n]:
            if path[p] is INF:
                continue
            cand = path[p] + self.connection(nodes[p][3], "EOS")
            if cand < best:
                best, best_last = cand, p
        if best_last is None:   # unreachable: unknown singles make every
            return [MorphToken(text, "unk", False)]  # position reachable
        out: List[MorphToken] = []
        idx = best_last
        while idx != -1:
            _s, _e, w, pos, _c, known = nodes[idx]
            out.append(MorphToken(w, pos, known))
            idx = back[idx]
        out.reverse()
        return out

    def segment(self, text: str) -> List[str]:
        """Surface forms of the best path (DictionarySegmenter-compatible,
        so this drops into DictionaryTokenizerFactory unchanged)."""
        return [t.surface for t in self.tokenize(text)]


class DictionaryTokenizerFactory(CJKCharTokenizerFactory):
    """TokenizerFactory whose CJK runs are segmented by a
    DictionarySegmenter/LatticeSegmenter instead of char bigrams — the
    Kuromoji-shaped plug-in exercising the reference's extension point
    for real.

    ``keep_pos``: optional POS whitelist (e.g. ``{"noun", "verb", "adj"}``)
    applied to analyzed CJK tokens — the PoStagger annotator tier
    (deeplearning4j-nlp-uima/.../text/annotator/PoStagger.java tags tokens
    so downstream consumers can select by part of speech; here the lattice
    carries the tags and the factory filters content words for Word2Vec /
    TF-IDF). Requires a segmenter with ``tokenize`` (LatticeSegmenter);
    non-CJK words pass through unfiltered."""

    def __init__(self, segmenter=None, keep_pos=None):
        super().__init__()
        self.segmenter = segmenter or DictionarySegmenter()
        if keep_pos is not None and not hasattr(self.segmenter, "tokenize"):
            raise ValueError(
                "keep_pos filtering needs a POS-aware segmenter "
                "(LatticeSegmenter), not "
                f"{type(self.segmenter).__name__}")
        self.keep_pos = frozenset(keep_pos) if keep_pos is not None else None

    def create(self, text: str):
        # walk the text the same way the parent does, but route CJK runs
        # through the segmenter instead of bigram-splitting them
        tokens: List[str] = []
        run: List[str] = []
        word: List[str] = []

        def flush_run():
            if run:
                if self.keep_pos is not None:
                    tokens.extend(
                        t.surface
                        for t in self.segmenter.tokenize("".join(run))
                        if t.pos in self.keep_pos)
                else:
                    tokens.extend(self.segmenter.segment("".join(run)))
                run.clear()

        def flush_word():
            if word:
                tokens.append("".join(word))
                word.clear()

        for ch in text:
            if self._is_cjk(ch):
                flush_word()
                run.append(ch)
            elif ch.isspace() or ch in "、。，．・「」『』（）!?！？":
                flush_run()
                flush_word()
            else:
                flush_run()
                word.append(ch)
        flush_run()
        flush_word()

        pre = self._pre

        class _T:
            def get_tokens(self_inner):
                out = []
                for t in tokens:
                    if pre is not None:
                        t = pre.pre_process(t)
                    if t:
                        out.append(t)
                return out
        return _T()


def mecab_tokenizer_factory(dicdir: Optional[str] = None):
    """Optional-dependency wrapper: a TokenizerFactory backed by a real
    installed MeCab binding (``fugashi`` or ``MeCab``) — the add-on-module
    path (deeplearning4j-nlp-japanese's role). Raises ImportError with
    instructions when neither binding is present."""
    tagger = None
    try:
        import fugashi
        tagger = fugashi.Tagger()
        parse = lambda text: [w.surface for w in tagger(text)]
    except ImportError:
        try:
            import MeCab
            tagger = MeCab.Tagger(f"-d {dicdir}" if dicdir else "")
            parse = lambda text: [
                line.split("\t")[0]
                for line in tagger.parse(text).splitlines()
                if line and line != "EOS"]
        except ImportError:
            raise ImportError(
                "mecab_tokenizer_factory needs an installed MeCab binding "
                "(pip install fugashi[unidic-lite] or mecab-python3); for "
                "offline environments use DictionaryTokenizerFactory with "
                "a bundled lexicon instead")

    class _MecabFactory(DefaultTokenizerFactory):
        def create(self, text: str):
            toks = parse(text)
            pre = self._pre

            class _T:
                def get_tokens(self_inner):
                    out = []
                    for t in toks:
                        if pre is not None:
                            t = pre.pre_process(t)
                        if t:
                            out.append(t)
                    return out
            return _T()

    return _MecabFactory()


# Korean particles (josa), longest-match-first — the twitter-korean-text
# stem/particle separation tier (deeplearning4j-nlp-korean/.../
# KoreanTokenizer.java wraps TwitterKoreanProcessorJava.tokenize, whose
# visible effect at this tier is splitting an eojeol into stem + josa)
_KO_JOSA = sorted(
    ("은 는 이 가 을 를 에 에서 에게 께 께서 와 과 도 만 의 로 으로 "
     "부터 까지 보다 처럼 마다 조차 밖에 라고 이라고 하고 이나 나 "
     "든지 라도 이라도 요 이며 며 랑 이랑").split(),
    key=len, reverse=True)

# Common-noun mini-lexicon validating stems before a SINGLE-syllable josa
# is stripped: many Korean nouns END in josa-lookalike syllables
# (고양이, 바나나), so suffix-only stripping would tokenize the same
# word differently bare vs particle-marked and split its embedding mass.
_KO_NOUNS = frozenset(
    ("고양이 강아지 개 새 물 우유 밥 사람 남자 여자 아이 학생 선생님 "
     "친구 가족 집 학교 회사 병원 도서관 공원 역 차 버스 기차 비행기 "
     "자전거 길 나라 한국 서울 일본 중국 미국 영어 한국어 일본어 말 "
     "글 책 신문 영화 음악 노래 사진 시간 오늘 내일 어제 아침 점심 "
     "저녁 밤 봄 여름 가을 겨울 날씨 비 눈 바람 하늘 바다 산 강 꽃 "
     "나무 색 돈 문 창문 책상 의자 옷 신발 모자 안경 우산 가방 전화 "
     "컴퓨터 커피 빵 고기 생선 야채 과일 계란 물건 일 이름 문제 질문 "
     "대답 뜻 이유 방법 결과 정보 이야기 마음 몸 손 발 귀 입 머리 "
     "얼굴 목소리 힘 바나나").split())


def _is_hangul(ch: str) -> bool:
    return 0xAC00 <= ord(ch) <= 0xD7A3


class KoreanTokenizerFactory(DefaultTokenizerFactory):
    """Korean eojeol tokenizer: whitespace-split, then each Hangul
    eojeol is separated into stem + trailing particle (josa) — the
    deeplearning4j-nlp-korean tier (KoreanTokenizer.java). This is the
    rule-based slice of what twitter-korean-text does; full
    morphological analysis plugs in through ``mecab_tokenizer_factory``
    (mecab-ko) exactly like the Japanese add-on path.

    Split policy (consistency beats recall): a single-syllable josa is
    stripped only when the remaining stem is a KNOWN noun (builtin
    mini-lexicon + ``add_noun``/``nouns=``) — otherwise 고양이 would
    tokenize as 고양+이 bare but 고양이 when particle-marked, splitting
    one word's embedding mass; multi-syllable josa (에서, 부터, ...)
    are rarely noun-final and strip from unknown stems too.

    ``emit_josa=False`` drops the particles (the common Word2Vec
    preprocessing — content words only)."""

    _STRIP = "。、，．！？!?\"'()[]{}.,;:«»\u201c\u201d\u2018\u2019"

    def __init__(self, emit_josa: bool = True, nouns=None):
        super().__init__()
        self.emit_josa = emit_josa
        self._nouns = set(_KO_NOUNS if nouns is None else nouns)

    def add_noun(self, word: str) -> "KoreanTokenizerFactory":
        self._nouns.add(word)
        return self

    def _split_eojeol(self, word: str) -> List[str]:
        if len(word) >= 2 and all(_is_hangul(c) for c in word):
            if word in self._nouns:
                return [word]  # a known bare noun is never split
            for josa in _KO_JOSA:
                if len(word) > len(josa) and word.endswith(josa):
                    stem = word[: -len(josa)]
                    if len(josa) >= 2 or stem in self._nouns:
                        parts = [stem]
                        if self.emit_josa:
                            parts.append(josa)
                        return parts
        return [word]

    def create(self, text: str):
        raw: List[str] = []
        for w in text.split():
            w = w.strip(self._STRIP)
            if w:
                raw.extend(self._split_eojeol(w))
        pre = self._pre

        class _T:
            def get_tokens(self_inner):
                out = []
                for t in raw:
                    if pre is not None:
                        t = pre.pre_process(t)
                    if t:
                        out.append(t)
                return out
        return _T()
