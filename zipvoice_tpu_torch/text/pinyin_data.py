"""Built-in hanzi -> tone3 pinyin fallback data.

The reference's ZH G2P is jieba + pypinyin ``lazy_pinyin(style=TONE3,
tone_sandhi=True, neutral_tone_with_five=True)`` (ref
zipvoice/tokenizer/tokenizer.py:298-307).  pypinyin is preferred when
installed; this module makes ZH tokenization *work offline* with a vendored
reading table:

* ``CHAR_PINYIN`` — most-common tone3 reading for the ~1600 highest-frequency
  characters (ranked by jieba's corpus frequencies), covering >97% of running
  text;
* ``WORD_PINYIN`` — whole-word overrides for common polyphones (长/重/还/都/
  得/着/发/当/...) and neutral-tone vocabulary (时候/朋友/...);
* third-tone, 不 and 一 tone-sandhi applied per word (an approximation of
  pypinyin's ToneSandhi).

This is a *fallback*: readings are the common case, not a full polyphone
model.  Output stays within the emilia tokens.txt inventory (initial+``0`` /
final+tone tokens, tone 5 = neutral).
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

# --------------------------------------------------------------------------
# Character table: "<hanzi><tone3>" pairs, frequency-ordered.
# --------------------------------------------------------------------------

_CHAR_DATA = (
    "一yi1是shi4人ren2了le5不bu4在zai4有you3大da4中zhong1国guo2和he2为wei2这zhe4"
    "上shang4他ta1个ge4地di4年nian2来lai2我wo3会hui4以yi3到dao4时shi2要yao4出chu1"
    "的de5生sheng1学xue2说shuo1道dao4民min2家jia1子zi3也ye3成cheng2行xing2下xia4"
    "们men5于yu2后hou4就jiu4发fa1自zi4之zhi1对dui4得de2主zhu3长chang2可ke3过guo4"
    "天tian1作zuo4分fen1方fang1用yong4多duo1你ni3着zhe5部bu4能neng2市shi4等deng3"
    "业ye4全quan2里li3工gong1公gong1经jing1本ben3都dou1而er2高gao1政zheng4法fa3"
    "面mian4门men2动dong4日ri4进jin4区qu1事shi4代dai4那na4去qu4心xin1小xiao3"
    "同tong2北bei3定ding4开kai1产chan3前qian2其qi2军jun1还hai2然ran2起qi3种zhong3"
    "所suo3如ru2现xian4理li3机ji1体ti3表biao3力li4好hao3外wai4与yu3文wen2当dang1"
    "两liang3实shi2重zhong4新xin1三san1么me5只zhi3山shan1水shui3关guan1明ming2"
    "从cong2化hua4平ping2建jian4又you4制zhi4南nan2内nei4西xi1没mei2此ci3将jiang1"
    "员yuan2名ming2手shou3最zui4东dong1头tou2者zhe3月yue4间jian1无wu2安an1看kan4"
    "见jian4各ge4城cheng2十shi2相xiang1但dan4已yi3些xie1正zheng4口kou3通tong1"
    "想xiang3度du4加jia1第di4她ta1合he2院yuan4物wu4性xing4战zhan4由you2位wei4"
    "常chang2点dian3海hai3意yi4场chang3武wu3使shi3次ci4二er4向xiang4治zhi4因yin1"
    "立li4数shu4样yang4身shen1情qing2入ru4原yuan2问wen4把ba3路lu4被bei4并bing4"
    "利li4石shi2老lao3教jiao4万wan4知zhi1级ji2量liang4任ren4江jiang1及ji2应ying1"
    "省sheng3资zi1委wei3务wu4元yuan2美mei3特te4期qi1世shi4湖hu2回hui2系xi4比bi3"
    "气qi4汉han4总zong3展zhan3电dian4科ke1金jin1先xian1声sheng1提ti2品pin3设she4"
    "或huo4义yi4王wang2社she4很hen3统tong3处chu4四si4首shou3共gong4马ma3形xing2"
    "己ji3儿er2司si1太tai4目mu4基ji1领ling3队dui4直zhi2计ji4别bie2女nv3权quan2"
    "话hua4少shao3流liu2命ming4至zhi4报bao4米mi3给gei3打da3变bian4果guo3书shu1"
    "清qing1活huo2几ji3州zhou1华hua2解jie3议yi4更geng4称cheng1程cheng2今jin1"
    "决jue2张zhang1导dao3术shu4府fu3才cai2保bao3交jiao1放fang4管guan3结jie2"
    "师shi1便bian4走zou3达da2族zu2反fan3再zai4题ti2色se4五wu3京jing1河he2接jie1"
    "条tiao2规gui1式shi4县xian4白bai2它ta1改gai3风feng1光guang1运yun4信xin4"
    "受shou4什shen2组zu3听ting1布bu4百bai3济ji4党dang3指zhi3论lun4强qiang2"
    "做zuo4取qu3技ji4黄huang2神shen2选xuan3记ji4斯si1真zhen1却que4职zhi2号hao4"
    "界jie4件jian4花hua1类lei4何he2眼yan3兵bing1传chuan2带dai4空kong1干gan4"
    "农nong2边bian1据ju4集ji2联lian2古gu3广guang3完wan2质zhi4阳yang2难nan2"
    "增zeng1历li4史shi3专zhuan1官guan1每mei3住zhu4商shang1即ji2步bu4认ren4"
    "车che1台tai2林lin2必bi4死si3游you2举ju3线xian4言yan2皇huang2土tu3团tuan2"
    "收shou1考kao3求qiu2德de2叫jiao4近jin4备bei4研yan2争zheng1非fei1具ju4李li3"
    "众zhong4连lian2调diao4感gan3转zhuan3笑xiao4革ge2该gai1持chi2始shi3英ying1"
    "克ke4士shi4尔er3让rang4拉la1思si1根gen1格ge2造zao4较jiao4际ji4亲qin1"
    "单dan1朝chao2红hong2型xing2价jia4校xiao4约yue1器qi4字zi4段duan4周zhou1"
    "亚ya4深shen1候hou4则ze2功gong1属shu3积ji1快kuai4图tu2火huo3千qian1准zhun3"
    "究jiu1往wang3极ji2育yu4装zhuang1许xu3参can1半ban4令ling4吃chi1观guan1"
    "鱼yu2精jing1办ban4像xiang4帝di4八ba1复fu4影ying3告gao4远yuan3群qun2包bao1"
    "整zheng3构gou4料liao4随sui2划hua4算suan4象xiang4容rong2示shi4投tou2势shi4"
    "热re4值zhi2夫fu1网wang3望wang4源yuan2息xi1语yu3股gu3铁tie3断duan4派pai4"
    "速su4怎zen3需xu1片pian4爱ai4律lv4纪ji4支zhi1早zao3况kuang4病bing4境jing4"
    "证zheng4编bian1越yue4局ju2推tui1满man3且qie3列lie4觉jue2服fu2双shuang1"
    "未wei4居ju1除chu2乐le4企qi3引yin3标biao1确que4织zhi1初chu1青qing1志zhi4"
    "率lv4项xiang4飞fei1球qiu2节jie2察cha2龙long2响xiang3药yao4站zhan4施shi1"
    "均jun1消xiao1客ke4失shi1轻qing1存cun2低di1甚shen4般ban1击ji1曾ceng2"
    "防fang2请qing3离li2落luo4显xian3罗luo2营ying2足zu2素su4视shi4护hu4副fu4"
    "食shi2创chuang4余yu2照zhao4兴xing1占zhan4巴ba1虽sui1洲zhou1村cun1费fei4"
    "易yi4试shi4星xing1木mu4黑hei1左zuo3宝bao3置zhi4跟gen1央yang1识shi2维wei2"
    "采cai3六liu4底di3宫gong1房fang2音yin1环huan2案an4批pi1切qie4斗dou4富fu4"
    "乡xiang1另ling4倒dao3若ruo4按an4查cha2故gu4突tu1责ze2严yan2桥qiao2模mo2"
    "仅jin3胜sheng4杀sha1围wei2席xi2态tai4破po4承cheng2招zhao1杨yang2负fu4"
    "层ceng2须xu1父fu4供gong1续xu4状zhuang4域yu4似si4依yi1银yin2范fan4修xiu1"
    "找zhao3九jiu3致zhi4密mi4终zhong1血xue4旅lv3钱qian2赛sai4独du2细xi4"
    "效xiao4玉yu4冲chong1获huo4习xi2医yi1演yan3毛mao2尽jin4脸lian3弹dan4"
    "楼lou2艺yi4航hang2陆lu4右you4协xie2七qi1攻gong1镇zhen4检jian3写xie3苏su1"
    "宗zong1章zhang1注zhu4阿a1抗kang4弟di4坐zuo4验yan4封feng1紧jin3劳lao2"
    "户hu4优you1财cai2养yang3适shi4陈chen2喜xi3卫wei4排pai2射she4哥ge1油you2"
    "刻ke4留liu2急ji2降jiang4念nian4云yun2微wei1伤shang1例li4景jing3拿na2"
    "绝jue2阶jie1座zuo4刘liu2刚gang1害hai4印yin4亿yi4沙sha1母mu3酒jiu3助zhu4"
    "闻wen2超chao1审shen3待dai4压ya1升sheng1送song4监jian1策ce4略lve4限xian4"
    "竟jing4香xiang1配pei4藏cang2敌di2呢ne5差cha4仍reng2兰lan2温wen1园yuan2"
    "树shu4征zheng1善shan4波bo1哪na3词ci2岛dao3止zhi3预yu4怕pa4继ji4皮pi2"
    "执zhi2味wei4份fen4角jiao3草cao3男nan2普pu3答da2益yi4谁shei2船chuan2"
    "惊jing1核he2街jie1夏xia4宣xuan1掌zhang3田tian2久jiu3著zhu4画hua4辑ji2"
    "奇qi2尼ni2剑jian4吧ba5谈tan2背bei4免mian3孩hai2礼li3材cai2愿yuan4洋yang2"
    "春chun1架jia4筑zhu4括kuo4晚wan3乱luan4乎hu1讲jiang3尚shang4良liang2"
    "友you3临lin2激ji1刀dao1夜ye4室shi4既ji4敢gan3邦bang1挥hui1昌chang1"
    "板ban3胡hu2欧ou1福fu2港gang3叶ye4简jian3苦ku3担dan1句ju4岁sui4荆jing1"
    "贵gui4娘niang2守shou3宜yi2衣yi1帮bang1块kuai4堂tang2额e2错cuo4剧ju4"
    "充chong1欢huan1够gou4孙sun1班ban1呼hu1阵zhen4销xiao1坚jian1练lian4"
    "脚jiao3退tui4读du2测ce4吴wu2希xi1宁ning2换huan4版ban3异yi4某mou3顾gu4"
    "曲qu3楚chu3典dian3朱zhu1毒du2菜cai4判pan4救jiu4宋song4茶cha2洪hong2"
    "含han2顺shun4啊a5鲜xian1败bai4货huo4矿kuang4端duan1兄xiong1归gui1"
    "冷leng3忙mang2买mai3险xian3康kang1评ping2肉rou4吗ma5厂chang3永yong3"
    "哈ha1沉chen2散san4遗yi2停ting2笔bi3假jia3输shu1牛niu2洞dong4松song1"
    "渐jian4顶ding3训xun4录lu4否fou3述shu4毕bi4督du1控kong4丰feng1献xian4"
    "姑gu1忽hu1爷ye2互hu4亮liang4纳na4襄xiang1登deng1咱zan2钟zhong1伯bo2"
    "臣chen2雄xiong2季ji4脑nao3介jie4鄂e4召zhao4饭fan4暗an4扩kuo4祖zu3齐qi2"
    "短duan3烈lie4赶gan3牌pai2恩en1诉su4移yi2诗shi1础chu3露lu4届jie4蒙meng2"
    "静jing4喝he1盘pan2卖mai4植zhi2授shou4伊yi1湾wan1博bo2痛tong4减jian3"
    "穿chuan1逐zhu2秘mi4庭ting2陵ling2固gu4禁jin4票piao4灵ling2杂za2姓xing4"
    "泽ze2吸xi1侧ce4庆qing4妈ma1遇yu4追zhui1甲jia3馆guan3补bu3唐tang2炮pao4"
    "沿yan2殿dian4刺ci4怪guai4彩cai3俄e2旧jiu4警jing3索suo3岸an4轮lun2妇fu4"
    "载zai4靠kao4附fu4毫hao2怀huai2软ruan3骨gu3探tan4雷lei2旁pang2罪zui4"
    "枪qiang1牙ya2迎ying2序xu4慢man4盛sheng4雨yu3墙qiang2恶e4谷gu3顿dun4"
    "危wei1稳wen3熟shu2概gai4酸suan1操cao1诸zhu1绿lv4佛fo2荣rong2针zhen1"
    "托tuo1宽kuan1折zhe2野ye3付fu4午wu3肯ken3库ku4厚hou4缺que1罢ba4耳er3"
    "屋wu1嘴zui3末mo4谢xie4巨ju4培pei2页ye4瓦wa3款kuan3犯fan4困kun4店dian4"
    "智zhi4拥yong1雪xue3翻fan1圣sheng4戏xi4旗qi2吉ji2婚hun1奖jiang3岩yan2"
    "疑yi2币bi4圆yuan2歌ge1廷ting2健jian4卡ka3烧shao1析xi1讨tao3跑pao3"
    "烟yan1误wu4仙xian1疗liao2舞wu3亡wang2闭bi4汽qi4伸shen1脱tuo1秋qiu1"
    "姐jie3繁fan2侵qin1川chuan1莫mo4麻ma2秀xiu4借jie4寻xun2私si1岗gang3"
    "卷juan4跳tiao4丽li4横heng2驻zhu4套tao4兼jian1您nin2君jun1丁ding1束shu4"
    "纸zhi3夺duo2袁yuan2灯deng1坏huai4坦tan3丝si1径jing4购gou4阴yin1"
    "床chuang2瞧qiao2择ze2墓mu4宪xian4峰feng1遍bian4鲁lu3庙miao4掉diao4"
    "丹dan1桃tao2御yu4舰jian4避bi4售shou4怒nu4课ke4播bo1拔ba2奥ao4延yan2"
    "虚xu1隐yin3粮liang2络luo4遭zao1摇yao2潜qian2庄zhuang1混hun4厅ting1"
    "婆po2奴nu2鼓gu3赵zhao4访fang3睡shui4震zhen4予yu3童tong2徐xu2韦wei2"
    "殖zhi2抓zhua1拜bai4吨dun1扬yang2址zhi3洛luo4休xiu1纵zong4逃tao2染ran3"
    "纷fen1贸mao4透tou4汇hui4灭mie4蛋dan4森sen1仪yi2塔ta3距ju4狐hu2融rong2"
    "郡jun4缓huan3聚ju4盖gai4拍pai1迹ji4忠zhong1释shi4润run4粉fen3涓juan1"
    "孔kong3岭ling3搜sou1紫zi3虑lv4促cu4抵di3钢gang1塞sai1寺si4津jin1液ye4"
    "码ma3虎hu3坛tan2珍zhen1硬ying4梁liang2奔ben1累lei4役yi4偏pian1迫po4"
    "锛ben1凡fan2损sun3壁bi4哭ku1替ti4税shui4综zong1伦lun2冰bing1盟meng2"
    "挂gua4韩han2竞jing4乌wu1尤you2弱ruo4铺pu4妹mei4秦qin2尊zun1竹zhu2"
    "珠zhu1迅xun4脉mai4泥ni2鬼gui3纯chun2睛jing1刑xing2途tu2隆long2潮chao2"
    "幅fu2杯bei1握wo4谋mou2剂ji4幸xing4奉feng4乘cheng2抱bao4朋peng2谓wei4"
    "频pin2崇chong2壮zhuang4骑qi2紝ren4恐kong3享xiang3鸡ji1虫chong2绍shao4"
    "铜tong2呈cheng2泛fan4械xie4摆bai3欲yu4奶nai3敬jing4措cuo4爆bao4暴bao4"
    "签qian1猛meng3郭guo1嘉jia1障zhang4缩suo1亦yi4废fei4搞gao3胞bao1埃ai1"
    "曰yue1撤che4暖nuan3寒han2订ding4俗su2绩ji4阻zu3盐yan2萨sa4勒le4"
    "忘wang4奏zou4孝xiao4贴tie1灰hui1梅mei2触chu4玩wan2默mo4醒xing3"
    "胸xiong1莲lian2篇pian1柱zhu4裁cai2啦la5淡dan4抢qiang3捕bu3闹nao4"
    "纺fang3截jie2讯xun4朗lang3誉yu4雅ya3忍ren3梦meng4伙huo3勇yong3峡xia2"
    "徒tu2丈zhang4尾wei3迷mi2唱chang4泉quan2泰tai4佳jia1残can2闪shan3伍wu3"
    "呀ya5疾ji2署shu3剩sheng4贼zei2冠guan4倾qing1豆dou4申shen1贫pin2诺nuo4"
    "麦mai4泪lei4羊yang2尖jian1辈bei4镜jing4涉she4贡gong4爹die1缘yuan2"
    "摩mo2妻qi1殊shu1贝bei4零ling2映ying4甘gan1骂ma4糖tang2岳yue4饮yin3"
    "奋fen4棉mian2雕diao1跃yue4汗han4冒mao4渡du4努nu3赞zan4启qi3阁ge2"
    "斤jin1裂lie4患huan4伏fu2池chi2鹿lu4洗xi3劲jin4晋jin4倍bei4圈quan1"
    "媒mei2箭jian4沟gou1锋feng1胆dan3凭ping2挑tiao1抬tai2闯chuang3隔ge2"
    "弄nong4曹cao2汤tang1苗miao2迁qian1叹tan4唯wei2振zhen4储chu3贯guan4"
    "彻che4桌zhuo1祭ji4符fu2僧seng1衡heng2炸zha4旋xuan2喊han3凤feng4黎li2"
    "郎lang2援yuan2肥fei2磁ci2忌ji4赏shang3辽liao2祥xiang2董dong3仁ren2"
    "辛xin1瑞rui4询xun2敏min3浪lang4貌mao4毁hui3昨zuo2巧qiao3腿tui3抽chou1"
    "荷he2陷xian4焦jiao1净jing4腹fu4弃qi4乃nai3湘xiang1亩mu3滑hua2狗gou3"
    "冬dong1宏hong2皆jie1番fan1尸shi1伟wei3桂gui4览lan3恢hui1龄ling2绕rao4"
    "趣qu4晶jing1坡po1魏wei4摸mo1伴ban4墨mo4浓nong2绪xu4舍she4蓝lan2"
    "荡dang4阅yue4井jing3鸿hong2旦dan4惯guan4症zheng4鸟niao3窗chuang1扎zha1"
    "辞ci2聘pin4穷qiong2堰yan4宇yu3键jian4荒huang1递di4恨hen4隶li4厉li4"
    "杜du4闲xian2腰yao1袭xi2侍shi4灾zai1涨zhang3叔shu1湿shi1寨zhai4幕mu4"
    "豪hao2郑zheng4磨mo2浮fu2薄bao2券quan4赤chi4腐fu3译yi4租zu1氧yang3"
    "戴dai4邓deng4煤mei2肠chang2牧mu4孤gu1诏zhao4妙miao4旨zhi3堡bao3册ce4"
    "锅guo1胖pang4柳liu3阔kuo4吹chui1丘qiu1趋qu1锦jin3颜yan2悬xuan2陶tao2"
    "拳quan2诚cheng2尺chi3晓xiao3插cha1蒋jiang3艇ting3勤qin2穴xue2摄she4"
    "燕yan4垂chui2罚fa2辆liang4戒jie4稀xi1腾teng2粗cu1袋dai4绘hui4炎yan2"
    "氏shi4肩jian1枝zhi1狂kuang2泊bo2估gu1杭hang2扑pu1臂bi4哲zhe2寡gua3"
    "偷tou1懂dong3琴qin2悲bei1盾dun4炒chao3稍shao1矛mao2愈yu4籍ji2颁ban1"
    "吐tu3呆dai1违wei2亭ting2眉mei2撞zhuang4贷dai4刊kan1巡xun2屈qu1堆dui1"
    "曼man4饰shi4碎sui4滚gun3悉xi1寄ji4浜bang1迟chi2描miao2污wu1辅fu3"
    "魔mo2烦fan2鼻bi2盗dao4餐can1辖xia2威wei1"
    # extension r3: the top missing characters ranked by jieba dict word
    # frequency (raised table coverage of that mass from 93.8% to ~95.7%)
    "幼you4凉liang2仗zhang4冈gang1澳ao4驾jia4菌jun1肚du4肃su4爸ba4仰yang3"
    "抚fu3慈ci2扶fu2盆pen2仿fang3炼lian4纲gang1倘tang3碗wan3杰jie2忧you1"
    "惜xi1扫sao3暂zan4祝zhu4跨kua4渔yu2宾bin1漫man4寿shou4猪zhu1涌yong3"
    "凝ning2邻lin2赴fu4恰qia4劝quan4仇chou2践jian4顷qing3赋fu4悄qiao1莱lai2"
    "拟ni3贤xian2愤fen4姆mu3乏fa2轰hong1粒li4逼bi1傅fu4陕shan3昆kun1"
    "溶rong2葬zang4燃ran2魂hun2挺ting3腊la4耐nai4犹you2辉hui1乳ru3陪pei2"
    "颇po1斜xie2棋qi2熊xiong2浅qian3沈shen3姊zi3返fan3翼yi4丧sang4拖tuo1"
    "惨can3俊jun4驱qu1袖xiu4惠hui4涂tu2牵qian1添tian1咸xian2详xiang2"
    "碰peng4割ge1侯hou2纤xian1柔rou2档dang4糊hu2岂qi3跪gui4拒ju4覆fu4"
    "绣xiu4吓xia4宿su4偶ou3揭jie1赖lai4烤kao3卢lu2娃wa2颗ke1邮you2"
    "扇shan4伐fa2循xun2衰shuai1弦xian2凯kai3羽yu3枚mei2帅shuai4锁suo3"
    "疏shu1搭da1俱ju4帐zhang4胶jiao1赫he4埋mai2蒸zheng1壳ke2彼bi3"
    "脏zang1箱xiang1浙zhe4弯wan1瓜gua1挡dang3拱gong3筹chou2疆jiang1"
    "肿zhong3膜mo2刷shua1杆gan1凶xiong1债zhai4甜tian2泡pao4玄xuan2"
    "贾jia3谱pu3夹jia1乾qian2遣qian3薪xin1灌guan4咬yao3尘chen2填tian2"
    "廊lang2钻zuan1丛cong2狼lang2牢lao2脊ji3熙xi1卒zu2碑bei1漠mo4"
    "躲duo3削xiao1徽hui1踏ta4贺he4朵duo3遵zun1狠hen3菲fei1撒sa1扰rao3"
    "蛇she2锡xi1炉lu2纹wen2匹pi3亏kui1鉴jian4慕mu4跌die1慌huang1穆mu4"
    "邀yao1芳fang1爬pa2豫yu4吾wu2奸jian1棒bang4淮huai2捷jie2耕geng1"
    "艘sou1齿chi3醉zui4脂zhi1兽shou4滴di1盈ying2卵luan3滋zi1柴chai2"
    "溪xi1浠xi1妃fei1碍ai4瓶ping2辩bian4遂sui4怨yuan4拨bo1肌ji1俘fu2"
    "挖wa1恒heng2励li4鸣ming2肝gan1腔qiang1偿chang2秒miao3拦lan2允yun3"
    "塑su4拆chai1靖jing4耗hao4凌ling2披pi1胁xie2吏li4纽niu3烂lan4"
    "尝chang2垸yuan4辟pi4耶ye1艰jian1佩pei4敦dun1疼teng2荐jian4厘li2"
    "匠jiang4柏bai3悠you1壤rang3拾shi2乔qiao2轴zhou2妖yao1喷pen1掩yan3"
    "璃li2孟meng4轨gui3歇xie1猜cai1晨chen2桑sang1坊fang1堤di1畅chang4"
    "瞎xia1氨an1辨bian4鞋xie2昏hun1恭gong1畜chu4浩hao4迪di2雾wu4丢diu1"
    "咨zi1擦ca1窝wo1洁jie2飘piao1搬ban1捉zhuo1奈nai4肤fu1愁chou2"
    "砖zhuan1辣la4幽you1嘛ma5赢ying2"
    # everyday food / object characters absent from the frequency head
    "苹ping2咖ka1啡fei1蔬shu1蕉jiao1葡pu2萄tao2莓mei2樱ying1柠ning2"
    "檬meng2橙cheng2"
)

CHAR_PINYIN: Dict[str, str] = {
    m.group(1): m.group(2)
    for m in re.finditer(r"([一-鿿])([a-z]+[1-5])", _CHAR_DATA)
}

# --------------------------------------------------------------------------
# Word overrides: polyphones whose common-word reading differs from the
# single-character default, and common neutral-tone vocabulary.
# --------------------------------------------------------------------------

_WORD_DATA: Tuple[Tuple[str, str], ...] = (
    # polyphones among the extension characters
    ("钻石", "zuan4 shi2"), ("畜牧", "xu4 mu4"), ("地壳", "di4 qiao4"),
    ("复辟", "fu4 bi4"), ("咖喱", "ga1 li2"), ("剥削", "bo1 xue1"),
    # 长 chang2 / zhang3
    ("长大", "zhang3 da4"), ("成长", "cheng2 zhang3"), ("增长", "zeng1 zhang3"),
    ("生长", "sheng1 zhang3"), ("长辈", "zhang3 bei4"), ("校长", "xiao4 zhang3"),
    ("市长", "shi4 zhang3"), ("部长", "bu4 zhang3"), ("队长", "dui4 zhang3"),
    ("家长", "jia1 zhang3"), ("厂长", "chang3 zhang3"), ("首长", "shou3 zhang3"),
    ("组长", "zu3 zhang3"), ("局长", "ju2 zhang3"), ("县长", "xian4 zhang3"),
    ("师长", "shi1 zhang3"), ("省长", "sheng3 zhang3"), ("董事长", "dong3 shi4 zhang3"),
    # 重 zhong4 / chong2
    ("重新", "chong2 xin1"), ("重复", "chong2 fu4"), ("重庆", "chong2 qing4"),
    ("重叠", "chong2 die2"), ("重组", "chong2 zu3"), ("重来", "chong2 lai2"),
    # 还 hai2 / huan2
    ("还给", "huan2 gei3"), ("归还", "gui1 huan2"), ("偿还", "chang2 huan2"),
    ("还款", "huan2 kuan3"), ("还清", "huan2 qing1"),
    # 都 dou1 / du1
    ("首都", "shou3 du1"), ("都市", "du1 shi4"), ("成都", "cheng2 du1"),
    # 为 wei2 / wei4
    ("为了", "wei4 le5"), ("因为", "yin1 wei4"), ("为什么", "wei4 shen2 me5"),
    ("为何", "wei4 he2"), ("为此", "wei4 ci3"),
    # 会 hui4 / kuai4
    ("会计", "kuai4 ji4"),
    # 发 fa1 / fa4
    ("头发", "tou2 fa5"), ("理发", "li3 fa4"), ("发型", "fa4 xing2"),
    # 得 de2 / de5 / dei3
    ("觉得", "jue2 de5"), ("记得", "ji4 de5"), ("值得", "zhi2 de5"),
    ("显得", "xian3 de5"), ("懂得", "dong3 de5"), ("免得", "mian3 de5"),
    ("晓得", "xiao3 de5"), ("舍不得", "she3 bu5 de5"), ("得到", "de2 dao4"),
    # 着 zhe5 / zhao2 / zhuo2
    ("着急", "zhao2 ji2"), ("着火", "zhao2 huo3"), ("着手", "zhuo2 shou3"),
    ("着重", "zhuo2 zhong4"), ("沉着", "chen2 zhuo2"), ("睡着", "shui4 zhao2"),
    # 当 dang1 / dang4
    ("上当", "shang4 dang4"), ("当作", "dang4 zuo4"), ("妥当", "tuo3 dang4"),
    ("适当", "shi4 dang4"), ("当天", "dang4 tian1"), ("当年", "dang4 nian2"),
    # 行 xing2 / hang2
    ("银行", "yin2 hang2"), ("行业", "hang2 ye4"), ("行列", "hang2 lie4"),
    ("同行", "tong2 hang2"), ("一行", "yi4 hang2"),
    # 了 le5 / liao3
    ("了解", "liao3 jie3"), ("了不起", "liao3 bu5 qi3"), ("受不了", "shou4 bu4 liao3"),
    # 地 di4 / de5
    ("慢慢地", "man4 man4 de5"),
    # 干 gan4 / gan1
    ("干净", "gan1 jing4"), ("干燥", "gan1 zao4"), ("饼干", "bing3 gan1"),
    ("干杯", "gan1 bei1"), ("干扰", "gan1 rao3"), ("干涉", "gan1 she4"),
    # 只 zhi3 / zhi1
    ("一只", "yi4 zhi1"), ("只有", "zhi3 you3"), ("船只", "chuan2 zhi1"),
    # 地/调/教/薄/传...
    ("调查", "diao4 cha2"), ("调整", "tiao2 zheng3"), ("调节", "tiao2 jie2"),
    ("空调", "kong1 tiao2"), ("协调", "xie2 tiao2"), ("调皮", "tiao2 pi2"),
    ("教书", "jiao1 shu1"), ("教给", "jiao1 gei3"),
    ("传记", "zhuan4 ji4"), ("自传", "zi4 zhuan4"),
    ("薄弱", "bo2 ruo4"), ("单薄", "dan1 bo2"),
    ("空白", "kong4 bai2"), ("空闲", "kong4 xian2"), ("填空", "tian2 kong4"),
    ("音乐", "yin1 yue4"), ("乐器", "yue4 qi4"), ("乐曲", "yue4 qu3"),
    ("处理", "chu3 li3"), ("处于", "chu3 yu2"), ("处罚", "chu3 fa2"),
    ("相处", "xiang1 chu3"), ("处境", "chu3 jing4"),
    ("差不多", "cha4 bu5 duo1"), ("出差", "chu1 chai1"), ("差别", "cha1 bie2"),
    ("差异", "cha1 yi4"), ("差距", "cha1 ju4"), ("误差", "wu4 cha1"),
    ("好奇", "hao4 qi2"), ("爱好", "ai4 hao4"), ("好像", "hao3 xiang4"),
    ("便宜", "pian2 yi5"),
    ("降落", "jiang4 luo4"), ("投降", "tou2 xiang2"), ("降服", "xiang2 fu2"),
    ("奔跑", "ben1 pao3"), ("投奔", "tou2 ben4"),
    ("弹琴", "tan2 qin2"), ("弹簧", "tan2 huang2"), ("子弹", "zi3 dan4"),
    ("数数", "shu3 shu4"), ("无数", "wu2 shu4"),
    ("几乎", "ji1 hu1"), ("茶几", "cha2 ji1"),
    ("假期", "jia4 qi1"), ("放假", "fang4 jia4"), ("假日", "jia4 ri4"),
    ("种地", "zhong4 di4"), ("种植", "zhong4 zhi2"), ("种树", "zhong4 shu4"),
    ("耕种", "geng1 zhong4"),
    ("中奖", "zhong4 jiang3"), ("打中", "da3 zhong4"), ("击中", "ji1 zhong4"),
    ("朝鲜", "chao2 xian3"), ("鲜为人知", "xian3 wei2 ren2 zhi1"),
    ("朝着", "chao2 zhe5"), ("朝向", "chao2 xiang4"), ("朝代", "chao2 dai4"),
    ("朝阳", "chao2 yang2"), ("唐朝", "tang2 chao2"), ("明朝", "ming2 chao2"),
    ("汗水", "han4 shui3"),
    ("血液", "xue4 ye4"),
    ("曲子", "qu3 zi5"), ("弯曲", "wan1 qu1"), ("曲线", "qu1 xian4"),
    ("曲折", "qu1 zhe2"),
    ("背包", "bei1 bao1"), ("背负", "bei1 fu4"),
    ("累计", "lei3 ji4"), ("积累", "ji1 lei3"), ("劳累", "lao2 lei4"),
    ("散步", "san4 bu4"), ("散文", "san3 wen2"), ("分散", "fen1 san4"),
    ("松散", "song1 san3"),
    ("应该", "ying1 gai1"), ("应用", "ying4 yong4"), ("应对", "ying4 dui4"),
    ("反应", "fan3 ying4"), ("适应", "shi4 ying4"), ("答应", "da1 ying5"),
    ("答理", "da1 li3"),
    ("兴趣", "xing4 qu4"), ("高兴", "gao1 xing4"), ("兴奋", "xing1 fen4"),
    ("兴旺", "xing1 wang4"),
    ("宁可", "ning4 ke3"), ("宁愿", "ning4 yuan4"),
    ("似的", "shi4 de5"),
    ("倒是", "dao4 shi4"), ("倒车", "dao4 che1"), ("摔倒", "shuai1 dao3"),
    ("打倒", "da3 dao3"),
    ("藏族", "zang4 zu2"), ("西藏", "xi1 zang4"),
    ("卷入", "juan3 ru4"), ("卷起", "juan3 qi3"), ("试卷", "shi4 juan4"),
    ("更加", "geng4 jia1"), ("更换", "geng1 huan4"), ("更新", "geng1 xin1"),
    ("半夜三更", "ban4 ye4 san1 geng1"),
    ("石头缝", "shi2 tou5 feng4"), ("缝隙", "feng4 xi4"), ("缝纫", "feng2 ren4"),
    # common neutral-tone vocabulary (pypinyin neutral word list excerpts)
    ("东西", "dong1 xi5"), ("地方", "di4 fang5"), ("时候", "shi2 hou5"),
    ("朋友", "peng2 you5"), ("衣服", "yi1 fu5"), ("先生", "xian1 sheng5"),
    ("姑娘", "gu1 niang5"), ("妈妈", "ma1 ma5"), ("爸爸", "ba4 ba5"),
    ("哥哥", "ge1 ge5"), ("姐姐", "jie3 jie5"), ("弟弟", "di4 di5"),
    ("妹妹", "mei4 mei5"), ("奶奶", "nai3 nai5"), ("爷爷", "ye2 ye5"),
    ("叔叔", "shu1 shu5"), ("太太", "tai4 tai5"), ("丈夫", "zhang4 fu5"),
    ("石头", "shi2 tou5"), ("木头", "mu4 tou5"), ("念头", "nian4 tou5"),
    ("里头", "li3 tou5"), ("外头", "wai4 tou5"), ("前头", "qian2 tou5"),
    ("后头", "hou4 tou5"), ("上头", "shang4 tou5"), ("下头", "xia4 tou5"),
    ("意思", "yi4 si5"), ("告诉", "gao4 su5"), ("什么", "shen2 me5"),
    ("怎么", "zen3 me5"), ("这么", "zhe4 me5"), ("那么", "na4 me5"),
    ("多么", "duo1 me5"), ("明白", "ming2 bai5"), ("清楚", "qing1 chu5"),
    ("漂亮", "piao4 liang5"), ("喜欢", "xi3 huan5"), ("商量", "shang1 liang5"),
    ("消息", "xiao1 xi5"), ("休息", "xiu1 xi5"), ("关系", "guan1 xi5"),
    ("客气", "ke4 qi5"), ("力气", "li4 qi5"), ("脾气", "pi2 qi5"),
    ("名堂", "ming2 tang5"), ("月亮", "yue4 liang5"), ("眼睛", "yan3 jing5"),
    ("耳朵", "er3 duo5"), ("指甲", "zhi3 jia5"), ("尾巴", "wei3 ba5"),
    ("嘴巴", "zui3 ba5"), ("事情", "shi4 qing5"), ("窗户", "chuang1 hu5"),
    ("钥匙", "yao4 shi5"), ("玻璃", "bo1 li5"), ("葡萄", "pu2 tao5"),
    ("萝卜", "luo2 bo5"), ("豆腐", "dou4 fu5"), ("点心", "dian3 xin5"),
    ("馒头", "man2 tou5"), ("知识", "zhi1 shi5"), ("认识", "ren4 shi5"),
    ("记号", "ji4 hao5"), ("热闹", "re4 nao5"), ("暖和", "nuan3 huo5"),
    ("街坊", "jie1 fang5"), ("功夫", "gong1 fu5"), ("师傅", "shi1 fu5"),
    ("队伍", "dui4 wu5"), ("部分", "bu4 fen5"), ("学问", "xue2 wen5"),
    ("买卖", "mai3 mai5"), ("官司", "guan1 si5"), ("规矩", "gui1 ju5"),
    ("打听", "da3 ting5"), ("打扮", "da3 ban5"), ("打扰", "da3 rao3"),
    ("招呼", "zhao1 hu5"), ("照顾", "zhao4 gu5"), ("折腾", "zhe1 teng5"),
    ("动静", "dong4 jing5"),
)

WORD_PINYIN: Dict[str, List[str]] = {
    w: r.split() for w, r in _WORD_DATA if all("一" <= c <= "鿿" for c in w)
}

# 子 as a word-final suffix is neutral (孩子 hai2zi5) except in these
# technical/relationship words where it keeps tone 3
_ZI3_WORDS = frozenset(
    "电子 分子 原子 量子 离子 粒子 中子 质子 孢子 父子 母子 男子 女子 王子 "
    "孔子 老子 孟子 庄子 弟子 君子 骨子 种子".split()
)


def _char_readings(word: str) -> List[str]:
    out = []
    for i, ch in enumerate(word):
        r = CHAR_PINYIN.get(ch)
        if r is None:
            out.append(ch)  # unknown char passes through (caller may skip)
            continue
        if (
            ch == "子"
            and i == len(word) - 1
            and len(word) >= 2
            and word not in _ZI3_WORDS
        ):
            r = "zi5"
        out.append(r)
    return out


def _is_tone3(s: str) -> bool:
    return len(s) >= 2 and s[:-1].isalpha() and s[-1] in "12345"


def _apply_sandhi(word: str, readings: List[str]) -> List[str]:
    """不/一 sandhi + third-tone sandhi within a word (approximation of
    pypinyin's ToneSandhi, itself adapted from PaddleSpeech)."""
    out = list(readings)
    n = len(out)
    for i in range(n - 1):
        if not (_is_tone3(out[i]) and _is_tone3(out[i + 1])):
            continue
        nxt_tone = out[i + 1][-1]
        if word[i] == "不":
            # 不 + tone4 -> bu2
            if nxt_tone == "4":
                out[i] = "bu2"
        elif word[i] == "一" and i > 0 and word[i - 1] == word[i + 1]:
            # reduplication 看一看 -> yi5
            out[i] = "yi5"
        elif word[i] == "一" and out[i] == "yi1":
            # 一 + tone4 -> yi2; 一 + tone1/2/3 -> yi4
            out[i] = "yi2" if nxt_tone == "4" else "yi4"
    # third-tone sandhi: in a run of 3rd tones, all but the last become 2nd
    for i in range(n - 1):
        if (
            _is_tone3(out[i]) and out[i][-1] == "3"
            and _is_tone3(out[i + 1]) and out[i + 1][-1] == "3"
        ):
            out[i] = out[i][:-1] + "2"
    return out


def word_to_pinyin(word: str) -> List[str]:
    """One jieba segment -> tone3 readings (non-hanzi pass through)."""
    if word in WORD_PINYIN:
        return list(WORD_PINYIN[word])
    readings = _char_readings(word)
    return _apply_sandhi(word, readings)


def lazy_pinyin_fallback(segs: List[str]) -> List[str]:
    """Vendored equivalent of pypinyin ``lazy_pinyin(segs, style=TONE3,
    tone_sandhi=True, neutral_tone_with_five=True)`` over jieba segments.
    Non-hanzi segments and unknown characters pass through unchanged (the
    tokenizer skips OOV tokens downstream, ref tokenizer.py:288-292)."""
    out: List[str] = []
    for seg in segs:
        out.extend(word_to_pinyin(seg))
    return out
