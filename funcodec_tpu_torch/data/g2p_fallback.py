"""Self-contained English grapheme-to-phoneme fallback (the port's copy of
funcodec_tpu/data/g2p_fallback.py).

The reference's phoneme path requires the external `g2p_en` wheel
(funcodec/text/phoneme_tokenizer.py:209), absent from this image. This
module provides a dependency-free stand-in producing the same ARPAbet
symbol set (stress-marked vowels, punctuation tokens, word-separating
spaces) so raw-string English TTS runs end-to-end:

  * a compact built-in lexicon of frequent English words (function words
    dominate running text);
  * letter-to-sound rules in the style of the public-domain NRL algorithm
    (Elovitz et al., 1976): context-sensitive per-letter rewrite rules over
    vowel/consonant classes, digraphs, magic-e, vowel teams and common
    suffixes;
  * number expansion for integers.

It is an approximation: words outside the lexicon get rule-derived
pronunciations with heuristic stress (first vowel of a content word gets
primary stress). For checkpoint-exact phoneme ids install g2p_en or feed
precomputed ids (text_type=ids).
"""

from __future__ import annotations

import re
from typing import List

VOWELS = "aeiou"
# phonemes considered vowels in ARPAbet (for stress marking)
ARPA_VOWELS = {
    "AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY",
    "IH", "IY", "OW", "OY", "UH", "UW",
}

# -- compact lexicon (exact g2p_en-style pronunciations) ---------------------

LEXICON = {
    "a": "AH0", "an": "AE1 N", "the": "DH AH0", "and": "AH0 N D",
    "of": "AH1 V", "to": "T UW1", "in": "IH0 N", "is": "IH1 Z",
    "it": "IH1 T", "you": "Y UW1", "that": "DH AE1 T", "he": "HH IY1",
    "she": "SH IY1", "was": "W AA1 Z", "for": "F AO1 R", "on": "AA1 N",
    "are": "AA1 R", "as": "AE1 Z", "with": "W IH1 DH", "his": "HH IH1 Z",
    "her": "HH ER0", "they": "DH EY1", "i": "AY1", "at": "AE1 T",
    "be": "B IY1", "this": "DH IH1 S", "have": "HH AE1 V",
    "from": "F R AH1 M", "or": "AO1 R", "one": "W AH1 N",
    "had": "HH AE1 D", "by": "B AY1", "word": "W ER1 D",
    "but": "B AH1 T", "not": "N AA1 T", "what": "W AH1 T",
    "all": "AO1 L", "were": "W ER1", "we": "W IY1", "when": "W EH1 N",
    "your": "Y AO1 R", "can": "K AE1 N", "said": "S EH1 D",
    "there": "DH EH1 R", "use": "Y UW1 S", "each": "IY1 CH",
    "which": "W IH1 CH", "do": "D UW1", "how": "HH AW1",
    "their": "DH EH1 R", "if": "IH1 F", "will": "W IH1 L",
    "up": "AH1 P", "other": "AH1 DH ER0", "about": "AH0 B AW1 T",
    "out": "AW1 T", "many": "M EH1 N IY0", "then": "DH EH1 N",
    "them": "DH EH1 M", "these": "DH IY1 Z", "so": "S OW1",
    "some": "S AH1 M", "would": "W UH1 D", "make": "M EY1 K",
    "like": "L AY1 K", "him": "HH IH1 M", "into": "IH0 N T UW1",
    "time": "T AY1 M", "has": "HH AE1 Z", "look": "L UH1 K",
    "two": "T UW1", "more": "M AO1 R", "write": "R AY1 T",
    "go": "G OW1", "see": "S IY1", "no": "N OW1", "way": "W EY1",
    "could": "K UH1 D", "people": "P IY1 P AH0 L", "my": "M AY1",
    "than": "DH AE1 N", "first": "F ER1 S T", "water": "W AO1 T ER0",
    "been": "B IH1 N", "who": "HH UW1", "its": "IH1 T S",
    "now": "N AW1", "find": "F AY1 N D", "long": "L AO1 NG",
    "down": "D AW1 N", "day": "D EY1", "did": "D IH1 D",
    "get": "G EH1 T", "come": "K AH1 M", "made": "M EY1 D",
    "may": "M EY1", "part": "P AA1 R T", "over": "OW1 V ER0",
    "new": "N UW1", "sound": "S AW1 N D", "take": "T EY1 K",
    "only": "OW1 N L IY0", "little": "L IH1 T AH0 L",
    "work": "W ER1 K", "know": "N OW1", "place": "P L EY1 S",
    "year": "Y IH1 R", "live": "L IH1 V", "me": "M IY1",
    "back": "B AE1 K", "give": "G IH1 V", "most": "M OW1 S T",
    "very": "V EH1 R IY0", "after": "AE1 F T ER0",
    "thing": "TH IH1 NG", "our": "AW1 ER0", "just": "JH AH1 S T",
    "name": "N EY1 M", "good": "G UH1 D", "sentence": "S EH1 N T AH0 N S",
    "man": "M AE1 N", "think": "TH IH1 NG K", "say": "S EY1",
    "great": "G R EY1 T", "where": "W EH1 R", "help": "HH EH1 L P",
    "through": "TH R UW1", "much": "M AH1 CH", "before": "B IH0 F AO1 R",
    "too": "T UW1", "mean": "M IY1 N", "old": "OW1 L D",
    "any": "EH1 N IY0", "same": "S EY1 M", "tell": "T EH1 L",
    "boy": "B OY1", "follow": "F AA1 L OW0", "came": "K EY1 M",
    "want": "W AA1 N T", "show": "SH OW1", "also": "AO1 L S OW0",
    "around": "ER0 AW1 N D", "form": "F AO1 R M", "three": "TH R IY1",
    "small": "S M AO1 L", "set": "S EH1 T", "put": "P UH1 T",
    "end": "EH1 N D", "does": "D AH1 Z", "another": "AH0 N AH1 DH ER0",
    "well": "W EH1 L", "large": "L AA1 R JH", "must": "M AH1 S T",
    "big": "B IH1 G", "even": "IY1 V IH0 N", "such": "S AH1 CH",
    "because": "B IH0 K AO1 Z", "turn": "T ER1 N", "here": "HH IY1 R",
    "why": "W AY1", "ask": "AE1 S K", "went": "W EH1 N T",
    "men": "M EH1 N", "read": "R IY1 D", "need": "N IY1 D",
    "land": "L AE1 N D", "different": "D IH1 F ER0 AH0 N T",
    "home": "HH OW1 M", "us": "AH1 S", "move": "M UW1 V",
    "try": "T R AY1", "kind": "K AY1 N D", "hand": "HH AE1 N D",
    "picture": "P IH1 K CH ER0", "again": "AH0 G EH1 N",
    "change": "CH EY1 N JH", "off": "AO1 F", "play": "P L EY1",
    "spell": "S P EH1 L", "air": "EH1 R", "away": "AH0 W EY1",
    "animal": "AE1 N AH0 M AH0 L", "house": "HH AW1 S",
    "point": "P OY1 N T", "page": "P EY1 JH", "letter": "L EH1 T ER0",
    "mother": "M AH1 DH ER0", "answer": "AE1 N S ER0",
    "found": "F AW1 N D", "study": "S T AH1 D IY0",
    "still": "S T IH1 L", "learn": "L ER1 N", "should": "SH UH1 D",
    "world": "W ER1 L D", "high": "HH AY1", "every": "EH1 V ER0 IY0",
    "near": "N IH1 R", "add": "AE1 D", "food": "F UW1 D",
    "between": "B IH0 T W IY1 N", "own": "OW1 N", "below": "B IH0 L OW1",
    "country": "K AH1 N T R IY0", "plant": "P L AE1 N T",
    "last": "L AE1 S T", "school": "S K UW1 L", "father": "F AA1 DH ER0",
    "keep": "K IY1 P", "tree": "T R IY1", "never": "N EH1 V ER0",
    "start": "S T AA1 R T", "city": "S IH1 T IY0", "earth": "ER1 TH",
    "eye": "AY1", "light": "L AY1 T", "thought": "TH AO1 T",
    "head": "HH EH1 D", "under": "AH1 N D ER0", "story": "S T AO1 R IY0",
    "saw": "S AO1", "left": "L EH1 F T", "don't": "D OW1 N T",
    "few": "F Y UW1", "while": "W AY1 L", "along": "AH0 L AO1 NG",
    "might": "M AY1 T", "close": "K L OW1 S", "something": "S AH1 M TH IH0 NG",
    "seem": "S IY1 M", "next": "N EH1 K S T", "hard": "HH AA1 R D",
    "open": "OW1 P AH0 N", "example": "IH0 G Z AE1 M P AH0 L",
    "begin": "B IH0 G IH1 N", "life": "L AY1 F", "always": "AO1 L W EY2 Z",
    "those": "DH OW1 Z", "both": "B OW1 TH", "paper": "P EY1 P ER0",
    "together": "T AH0 G EH1 DH ER0", "got": "G AA1 T",
    "group": "G R UW1 P", "often": "AO1 F AH0 N", "run": "R AH1 N",
    "important": "IH0 M P AO1 R T AH0 N T", "until": "AH0 N T IH1 L",
    "children": "CH IH1 L D R AH0 N", "side": "S AY1 D",
    "feet": "F IY1 T", "car": "K AA1 R", "mile": "M AY1 L",
    "night": "N AY1 T", "walk": "W AO1 K", "white": "W AY1 T",
    "sea": "S IY1", "began": "B IH0 G AE1 N", "grow": "G R OW1",
    "took": "T UH1 K", "river": "R IH1 V ER0", "four": "F AO1 R",
    "carry": "K AE1 R IY0", "state": "S T EY1 T", "once": "W AH1 N S",
    "book": "B UH1 K", "hear": "HH IY1 R", "stop": "S T AA1 P",
    "without": "W IH0 TH AW1 T", "second": "S EH1 K AH0 N D",
    "later": "L EY1 T ER0", "miss": "M IH1 S", "idea": "AY0 D IY1 AH0",
    "enough": "IH0 N AH1 F", "eat": "IY1 T", "face": "F EY1 S",
    "watch": "W AA1 CH", "far": "F AA1 R", "really": "R IH1 L IY0",
    "almost": "AO1 L M OW2 S T", "let": "L EH1 T", "above": "AH0 B AH1 V",
    "girl": "G ER1 L", "sometimes": "S AH1 M T AY2 M Z",
    "mountain": "M AW1 N T AH0 N", "cut": "K AH1 T", "young": "Y AH1 NG",
    "talk": "T AO1 K", "soon": "S UW1 N", "list": "L IH1 S T",
    "song": "S AO1 NG", "being": "B IY1 IH0 NG", "leave": "L IY1 V",
    "family": "F AE1 M AH0 L IY0", "it's": "IH1 T S",
    "hello": "HH AH0 L OW1", "world's": "W ER1 L D Z",
    "speech": "S P IY1 CH", "voice": "V OY1 S", "audio": "AO1 D IY0 OW2",
    "zero": "Z IH1 R OW0", "two's": "T UW1 Z", "three's": "TH R IY1 Z",
    "five": "F AY1 V", "six": "S IH1 K S", "seven": "S EH1 V AH0 N",
    "eight": "EY1 T", "nine": "N AY1 N", "ten": "T EH1 N",
    "hundred": "HH AH1 N D R AH0 D", "thousand": "TH AW1 Z AH0 N D",
    "million": "M IH1 L Y AH0 N", "twenty": "T W EH1 N T IY0",
    "thirty": "TH ER1 T IY0", "forty": "F AO1 R T IY0",
    "fifty": "F IH1 F T IY0", "sixty": "S IH1 K S T IY0",
    "seventy": "S EH1 V AH0 N T IY0", "eighty": "EY1 T IY0",
    "ninety": "N AY1 N T IY0", "eleven": "IH0 L EH1 V AH0 N",
    "twelve": "T W EH1 L V", "thirteen": "TH ER1 T IY1 N",
    "fourteen": "F AO1 R T IY1 N", "fifteen": "F IH1 F T IY1 N",
    "sixteen": "S IH1 K S T IY1 N", "seventeen": "S EH1 V AH0 N T IY1 N",
    "eighteen": "EY0 T IY1 N", "nineteen": "N AY1 N T IY1 N",
}

# -- letter-to-sound rules (NRL style) ----------------------------------------
# (left_context, letters, right_context, phonemes)
# context classes: '#' one+ vowels, '^' one consonant, ':' zero+ consonants,
# '.' voiced consonant, '%' e-ish suffix, '+' front vowel (e/i/y),
# ' ' word boundary; right context additionally supports 'E$' literal
# end-of-word 'e'.

RULES = {
    "a": [
        ("", "ar", "", "AA R"), ("", "air", "", "EH R"),
        ("", "ai", "", "EY"), ("", "ay", "", "EY"), ("", "au", "", "AO"),
        ("", "aw", "", "AO"), (" ", "al", "l", "AO"),
        ("", "a", "^e ", "EY"), ("", "a", "^i ", "EY"), ("", "a", "^%", "EY"),
        ("", "a", "tio", "EY"), ("", "a", "", "AE"),
    ],
    "b": [("", "bb", "", "B"), ("", "b", "", "B")],
    "c": [
        ("", "ch", "", "CH"), ("", "ck", "", "K"),
        ("", "c", "+", "S"), ("", "cc", "", "K"), ("", "c", "", "K"),
    ],
    "d": [("", "dd", "", "D"), ("", "d", "", "D")],
    "e": [
        (":", "e", " ", ""),  # silent final e after consonant
        ("", "ear", "", "IH R"), ("", "ee", "", "IY"),
        ("", "ea", "", "IY"), ("", "ew", "", "UW"), ("", "ei", "", "IY"),
        ("", "er", "", "ER"), ("", "ey", "", "IY"),
        ("", "e", "^e ", "IY"), ("", "e", "", "EH"),
    ],
    "f": [("", "ff", "", "F"), ("", "f", "", "F")],
    "g": [
        ("", "gh", "", ""), ("", "gg", "", "G"),
        ("", "g", "+", "JH"), ("", "g", "", "G"),
    ],
    "h": [("", "h", "#", "HH"), ("", "h", "", "")],
    "i": [
        ("", "igh", "", "AY"), ("", "ie", " ", "AY"), ("", "ie", "", "IY"),
        ("", "ir", "", "ER"), ("", "ing", " ", "IH NG"),
        ("", "i", "^e ", "AY"), ("", "i", "^%", "AY"),
        (" ", "i", " ", "AY"), ("", "ion", " ", "AH N"),
        ("", "i", "", "IH"),
    ],
    "j": [("", "j", "", "JH")],
    "k": [(" ", "kn", "", "N"), ("", "k", "", "K")],
    "l": [("", "ll", "", "L"), ("", "l", "", "L")],
    "m": [("", "mm", "", "M"), ("", "m", "", "M")],
    "n": [("", "ng", "", "NG"), ("", "nn", "", "N"), ("", "n", "", "N")],
    "o": [
        ("", "ough", " ", "OW"), ("", "ought", "", "AO T"),
        ("", "oo", "", "UW"), ("", "ou", "", "AW"), ("", "ow", " ", "OW"),
        ("", "ow", "", "AW"), ("", "oy", "", "OY"), ("", "oi", "", "OY"),
        ("", "or", "", "AO R"), ("", "oa", "", "OW"),
        ("", "o", "^e ", "OW"), ("", "o", "^%", "OW"), ("", "o", " ", "OW"),
        ("", "o", "", "AA"),
    ],
    "p": [("", "ph", "", "F"), ("", "pp", "", "P"), ("", "p", "", "P")],
    "q": [("", "qu", "", "K W"), ("", "q", "", "K")],
    "r": [("", "rr", "", "R"), ("", "r", "", "R")],
    "s": [
        ("", "sh", "", "SH"), ("#", "sion", " ", "ZH AH N"),
        ("", "sion", " ", "SH AH N"), ("", "ss", "", "S"),
        ("#", "s", " ", "Z"), (".", "s", " ", "Z"), ("", "s", "", "S"),
    ],
    "t": [
        ("", "tion", " ", "SH AH N"), ("", "th", "", "TH"),
        ("", "tt", "", "T"), ("", "t", "", "T"),
    ],
    "u": [
        ("", "ur", "", "ER"), ("", "u", "^e ", "UW"),
        ("", "u", "", "AH"),
    ],
    "v": [("", "v", "", "V")],
    "w": [(" ", "wh", "", "W"), (" ", "wr", "", "R"), ("", "w", "", "W")],
    "x": [(" ", "x", "", "Z"), ("", "x", "", "K S")],
    "y": [
        (" ", "y", "", "Y"), ("", "y", " ", "IY"),
        ("", "y", "^e", "AY"), ("", "y", "", "IH"),
    ],
    "z": [("", "zz", "", "Z"), ("", "z", "", "Z")],
}

_VOICED = set("bdvgjlmnrwz")
_FRONT = set("eiy")


def _match_left(ctx: str, word: str, pos: int) -> bool:
    i = pos - 1
    for c in reversed(ctx):
        if c == " ":
            if i >= 0:
                return False
        elif c == "#":
            if i < 0 or word[i] not in VOWELS:
                return False
            while i >= 0 and word[i] in VOWELS:
                i -= 1
        elif c == "^":
            if i < 0 or word[i] in VOWELS:
                return False
            i -= 1
        elif c == ":":
            while i >= 0 and word[i] not in VOWELS:
                i -= 1
        elif c == ".":
            if i < 0 or word[i] not in _VOICED:
                return False
            i -= 1
        else:
            if i < 0 or word[i] != c:
                return False
            i -= 1
    return True


def _match_right(ctx: str, word: str, pos: int) -> bool:
    i = pos
    for c in ctx:
        if c == " ":
            if i < len(word):
                return False
        elif c == "#":
            if i >= len(word) or word[i] not in VOWELS:
                return False
            while i < len(word) and word[i] in VOWELS:
                i += 1
        elif c == "^":
            if i >= len(word) or word[i] in VOWELS:
                return False
            i += 1
        elif c == ":":
            while i < len(word) and word[i] not in VOWELS:
                i += 1
        elif c == "+":
            if i >= len(word) or word[i] not in _FRONT:
                return False
            i += 1
        elif c == "%":
            rest = word[i:]
            if not any(
                rest.startswith(suf) for suf in ("e", "er", "es", "ed", "ing", "ely")
            ):
                return False
            i = len(word)
        else:
            if i >= len(word) or word[i] != c:
                return False
            i += 1
    return True


def _rules_word(word: str) -> List[str]:
    """Letter-to-sound pass over one lowercase word."""
    phones: List[str] = []
    pos = 0
    while pos < len(word):
        ch = word[pos]
        applied = False
        for left, letters, right, ph in RULES.get(ch, ()):
            if not word.startswith(letters, pos):
                continue
            if not _match_left(left, word, pos):
                continue
            if not _match_right(right, word, pos + len(letters)):
                continue
            if ph:
                phones.extend(ph.split())
            pos += len(letters)
            applied = True
            break
        if not applied:
            pos += 1  # unknown character: skip
    return phones


def _stress(phones: List[str]) -> List[str]:
    """Primary stress on the first vowel, 0 elsewhere (heuristic)."""
    out = []
    first = True
    for p in phones:
        if p in ARPA_VOWELS:
            out.append(p + ("1" if first else "0"))
            first = False
        else:
            out.append(p)
    return out


_ONES = "zero one two three four five six seven eight nine".split()
_TEENS = ("ten eleven twelve thirteen fourteen fifteen sixteen seventeen "
          "eighteen nineteen").split()
_TENS = ("_ _ twenty thirty forty fifty sixty seventy eighty ninety").split()


def _num_words(n: int) -> List[str]:
    if n < 10:
        return [_ONES[n]]
    if n < 20:
        return [_TEENS[n - 10]]
    if n < 100:
        return [_TENS[n // 10]] + ([_ONES[n % 10]] if n % 10 else [])
    if n < 1000:
        return [_ONES[n // 100], "hundred"] + (_num_words(n % 100) if n % 100 else [])
    if n < 1_000_000:
        return _num_words(n // 1000) + ["thousand"] + (
            _num_words(n % 1000) if n % 1000 else []
        )
    return list(str(n))  # give up gracefully: digit names


def expand_numbers(text: str) -> str:
    def repl(m):
        return " " + " ".join(_num_words(int(m.group(0)))) + " "

    return re.sub(r"\d+", repl, text)


class G2pFallback:
    """Callable with the g2p_en interface: text -> list of phonemes with
    word-separating " " tokens and punctuation passed through."""

    PUNCT = {",", ".", "!", "?", ";", ":"}

    def __call__(self, text: str) -> List[str]:
        text = expand_numbers(text.lower())
        tokens: List[str] = []
        words = re.findall(r"[a-z']+|[,.!?;:]", text)
        for w in words:
            if tokens:
                tokens.append(" ")
            if w in self.PUNCT:
                tokens.append(w)
                continue
            if w in LEXICON:
                tokens.extend(LEXICON[w].split())
                continue
            # strip possessive for lexicon lookup
            if w.endswith("'s") and w[:-2] in LEXICON:
                tokens.extend(LEXICON[w[:-2]].split())
                tokens.append("Z")
                continue
            base = w.replace("'", "")
            tokens.extend(_stress(_rules_word(base)))
        return tokens
